/* C stepper for the batched lockstep SM engine (repro_torch.core.batched).
 *
 * A direct transliteration of the scalar hot path in
 * repro_torch/core/simulator.py::SMSimulator.advance, operating on the SAME
 * stacked batch arrays the numpy stepper uses (one row per cell). Each
 * call advances every live, unpaused cell until a slice boundary.
 * Epoch boundaries, warp retirements, timeline samples and throttled
 * stretches of the known policy families (CCWS, statPCAL, CIAO,
 * Best-SWL rotation) are serviced HERE, in-stepper, as transliterations
 * of the repro_torch.core.epoch kernels; a cell pauses back into Python only
 * for unknown policy subclasses (F_OBJECT / WD_OBJECT rows) and for
 * row finalization. Decision floats follow the fixed-point contract of
 * repro_torch/core/epoch.py: integer counters below 2**53, each cutoff
 * decision a single-rounding double compare (hits*act <> cutoff*win),
 * so numpy and C agree bit-for-bit (tests/test_batched.py). Compile
 * with -ffp-contract=off so no compare side is fused.
 *
 * Compiled on demand by repro_torch/core/_cstep.py with the system C compiler
 * (no Python.h — driven through ctypes). Field order of Params must
 * match the ctypes.Structure in _cstep.py exactly.
 */
#include <stdint.h>

typedef int64_t i64;
typedef signed char i8;
typedef uint64_t u64;

enum {
    P_EPOCH = 1,
    P_TIMELINE = 2,
    P_WARPDONE = 4,
    P_THROTTLE = 8,
    P_CAP = 16,   /* legacy: slice stops at the cycle cap use P_SLICE */
    P_SLICE = 32, /* reached until[b] (slice boundary or cycle cap)   */
    P_FINALIZE = 64 /* row completed in-stepper; Python only finalizes */
};

/* policy families / warp-done kinds (mirror repro_torch.core.batched) */
enum { F_PASSIVE = 0, F_CCWS = 1, F_STATP = 2, F_CIAO = 3, F_OBJECT = 4 };
enum { WD_NOOP = 0, WD_SWL = 1, WD_STATP = 2, WD_OBJECT = 3 };

#define HUGE_T ((i64)1 << 62)

typedef struct {
    /* dimensions */
    i64 B, n, L, P;
    i64 nf, l1_sets, l1_ways;
    i64 vnf, v_sets, v_k;
    i64 l2nf, l2_sets, l2_ways;
    i64 nrb, dram_channels;
    i64 nw, list_entries, sat_max;
    /* config scalars (shape-class constants) */
    i64 xor_hash, reuse_filter;
    i64 max_mlp, line_shift;
    /* per-row config planes: knobs that vary cell to cell within one
     * shape class, indexed [b] like mem_of */
    i64 *lat_l1, *lat_smem, *lat_migrate, *lat_l2, *lat_dram, *dram_gap;
    i64 *low_epoch;
    /* per-warp planes (B x n [x ...]) */
    i64 *ready, *toks, *op_idx, *n_ops, *pend;
    i8 *done, *avail, *iso, *byp, *live, *runnable;
    i64 *u_of, *n_of, *region_blocks, *mem_of, *until;
    /* per-row scalars */
    i64 *cycle, *instr, *li, *next_epoch, *window_mark;
    i64 *last_wid, *tick, *l2_tick;
    /* cache planes */
    i64 *l1_tags, *l1_owners, *l1_stamp;
    i8 *l1_reused;
    i64 *smem_tags, *smem_owner;
    i64 *v_addr, *v_evic, *v_head, *v_count, *v_inserts;
    i64 *l2_tags, *l2_stamp, *l2_hits, *l2_misses;
    i64 *dram_free, *dram_requests;
    /* event counters */
    i64 *cnt_l1_hit, *cnt_l1_miss, *cnt_smem_hit, *cnt_smem_miss;
    i64 *cnt_smem_migrate, *cnt_bypass, *cnt_evictions;
    i64 *cnt_smem_evictions, *cnt_vta_hits, *vta_hit_events;
    i64 *cnt_dram_reqs;   /* per-row; dram_requests is per hierarchy */
    /* control */
    i64 *pause, *last_done_wid;
    /* detector hooks: det_ptrs[b*4 + {irs_hits, vta_hits, interf, sat}];
       score_ptrs[b] is CCWS's score buffer (0 = policy has no
       on_mem_event hook) */
    u64 *det_ptrs, *score_ptrs;
    i64 *score_bump;
    i64 *pair_dense; /* B x (n+1) x n, row 0 = evictor==-1 guard */
    /* ---- in-stepper epoch / warp-done / timeline servicing ---- */
    i64 timeline_every, tl_cap;
    i64 *high_epoch, *aging_high, *stride_ok;   /* per-row knobs */
    double *low_cutoff, *high_cutoff;
    i8 *fam, *mode_p, *mode_t;          /* policy family / CIAO modes */
    i8 *allowed_pl, *isolated_pl, *bypass_pl;   /* policy mask planes */
    i8 *sp_bypass, *sp_base;            /* statPCAL mode + base set */
    double *sp_thresh;
    i64 *det_inst_total, *det_irs_inst, *irs_off;
    i64 *low_idx, *high_idx, *low_base_inst, *high_base_inst;
    i64 *high_crossings, *low_base_hits, *high_base_hits;
    i64 *low_snap_hits, *high_snap_hits;
    i64 *low_snap_win, *high_snap_win, *low_snap_act, *high_snap_act;
    i64 *pair_list, *wid_sets;
    i64 *ccws_base, *ccws_budget;
    i64 *ciao_stall, *ciao_iso, *stall_len, *iso_len;
    i64 *wd_kind, *swl_next, *remaining;
    i64 *tl_cycle, *tl_act, *tl_n, *tl_last_instr, *tl_last_cycle;
    double *tl_dipc;
} Params;

static i64 l1_set(const Params *p, i64 line)
{
    i64 s = line % p->l1_sets;
    if (p->xor_hash)
        s = (s ^ ((line / p->l1_sets) % p->l1_sets)) % p->l1_sets;
    return s;
}

/* circular-FIFO insert; the caller has excluded self-eviction */
static void vta_insert(const Params *p, i64 b, i64 owner, i64 line,
                       i64 evictor)
{
    i64 k = p->v_k;
    i64 s = owner % p->v_sets;
    i64 *addr = p->v_addr + b * p->vnf + s * k;
    i64 *evic = p->v_evic + b * p->vnf + s * k;
    i64 *head = p->v_head + b * p->v_sets + s;
    i64 *cnt = p->v_count + b * p->v_sets + s;
    if (*cnt == k) { /* full: FIFO-drop the oldest */
        addr[*head] = line;
        evic[*head] = evictor;
        *head = (*head + 1) % k;
    } else {
        i64 f = (*head + *cnt) % k;
        addr[f] = line;
        evic[f] = evictor;
        *cnt += 1;
    }
    p->v_inserts[b] += 1;
}

/* membership scan + FIFO pop of the oldest match + interference-list
 * bookkeeping (the fused interference.on_miss). Returns 1 on a VTA hit.
 * Physical slots outside the logical FIFO window are always -1, so the
 * membership scan over all k slots equals the scalar core's dict. */
static int vta_probe(const Params *p, i64 b, i64 wid, i64 line)
{
    i64 k = p->v_k;
    i64 s = wid % p->v_sets;
    i64 *addr = p->v_addr + b * p->vnf + s * k;
    int member = 0;
    for (i64 j = 0; j < k; j++)
        if (addr[j] == line) { member = 1; break; }
    if (!member)
        return 0;
    i64 *evic = p->v_evic + b * p->vnf + s * k;
    i64 h = p->v_head[b * p->v_sets + s];
    i64 cc = p->v_count[b * p->v_sets + s];
    i64 evictor = -1;
    for (i64 j = 0; j < cc; j++) { /* oldest-first logical order */
        i64 f = (h + j) % k;
        if (addr[f] == line) {
            evictor = evic[f];
            for (i64 jj = j; jj < cc - 1; jj++) {
                i64 f0 = (h + jj) % k;
                i64 f1 = (h + jj + 1) % k;
                addr[f0] = addr[f1];
                evic[f0] = evic[f1];
            }
            i64 fl = (h + cc - 1) % k;
            addr[fl] = -1;
            evic[fl] = -1;
            p->v_count[b * p->v_sets + s] = cc - 1;
            ((i64 *)(uintptr_t)p->det_ptrs[b * 4 + 1])[s] += 1;
            break;
        }
    }
    p->vta_hit_events[b] += 1;
    p->cnt_vta_hits[b] += 1;
    ((i64 *)(uintptr_t)p->det_ptrs[b * 4 + 0])[wid % p->nw] += 1;
    p->pair_dense[b * (p->n + 1) * p->n + (evictor + 1) * p->n + wid] += 1;
    i64 i = wid % p->list_entries;
    i64 *interf = (i64 *)(uintptr_t)p->det_ptrs[b * 4 + 2];
    i64 *sat = (i64 *)(uintptr_t)p->det_ptrs[b * 4 + 3];
    if (interf[i] == evictor) {
        if (sat[i] < p->sat_max)
            sat[i] += 1;
    } else if (interf[i] == -1) {
        interf[i] = evictor;
        sat[i] = 0;
    } else if (sat[i] == 0) {
        interf[i] = evictor;
    } else {
        sat[i] -= 1;
    }
    return 1;
}

/* ------------- in-stepper epoch / warp-done / timeline service -------
 * Per-row transliterations of the repro_torch.core.epoch kernels. Each
 * mirrors what BatchedSMEngine's vectorized drain would do for one row,
 * at exactly the same point in the row's instruction stream. */

/* re-derive the dispatch masks from the policy mask planes (the tail
 * of _epoch_batch) */
static void refresh_row(const Params *p, i64 b)
{
    const i64 n = p->n;
    i8 *avail = p->avail + b * n;
    i8 *iso = p->iso + b * n;
    i8 *byp = p->byp + b * n;
    const i8 *al = p->allowed_pl + b * n;
    const i8 *is = p->isolated_pl + b * n;
    const i8 *bp = p->bypass_pl + b * n;
    const i8 *done = p->done + b * n;
    for (i64 i = 0; i < n; i++) {
        avail[i] = al[i] && !done[i];
        iso[i] = is[i];
        byp[i] = bp[i];
    }
}

/* CCWS: score decay + lost-locality throttling (epoch.ccws_tick) */
static void ccws_tick_row(const Params *p, i64 b)
{
    const i64 n = p->n;
    i64 *s = p->score_ptrs[b] ? (i64 *)(uintptr_t)p->score_ptrs[b]
                              : (i64 *)0;
    if (!s)
        return;
    const i64 base = p->ccws_base[b], budget = p->ccws_budget[b];
    const i8 *done = p->done + b * n;
    i8 *al = p->allowed_pl + b * n;
    for (i64 i = 0; i < n; i++) {
        i64 d = s[i] / 8;
        if (d < 1)
            d = 1;
        s[i] -= d;
        if (s[i] < base)
            s[i] = base;
    }
    /* stable sort: alive warps by descending score, dead warps last
     * (keys match epoch.ccws_tick's -score / _DEAD_KEY argsort) */
    i64 order[n];
    for (i64 i = 0; i < n; i++)
        order[i] = i;
    for (i64 i = 1; i < n; i++) {
        i64 o = order[i];
        i64 key = done[o] ? HUGE_T : -s[o];
        i64 j = i - 1;
        while (j >= 0) {
            i64 oj = order[j];
            i64 kj = done[oj] ? HUGE_T : -s[oj];
            if (kj <= key)
                break;
            order[j + 1] = oj;
            j--;
        }
        order[j + 1] = o;
    }
    i64 csum = 0;
    for (i64 r = 0; r < n; r++) {
        i64 w = order[r];
        i64 blocked = 0;
        if (!done[w]) {
            csum += s[w];
            blocked = (csum > budget) && (r > 0);
        }
        al[w] = !blocked;
    }
}

/* statPCAL: bandwidth-driven bypass flip (epoch.statpcal_tick); util
 * is the single-rounding double of BatchedSMEngine._util_vec */
static void statp_tick_row(const Params *p, i64 b, i64 cycle)
{
    const i64 n = p->n;
    double util = 0.0;
    if (cycle > 0) {
        i64 den = p->dram_channels * cycle;
        if (den < 1)
            den = 1;
        util = (double)(p->dram_requests[p->mem_of[b]] * p->dram_gap[b])
            / (double)den;
        if (util > 1.0)
            util = 1.0;
    }
    int nb = util < p->sp_thresh[b];
    if (nb == (int)p->sp_bypass[b])
        return;
    p->sp_bypass[b] = (i8)nb;
    i8 *al = p->allowed_pl + b * n;
    i8 *bp = p->bypass_pl + b * n;
    const i8 *bm = p->sp_base + b * n;
    for (i64 i = 0; i < n; i++) {
        al[i] = nb ? 1 : bm[i];
        bp[i] = nb ? !bm[i] : 0;
    }
}

/* the pair-list trigger guard of Algorithm 1 lines 4-19: cumulative
 * IRS of trigger k at or below the low cutoff (epoch.irs_cum_leq) */
static int ciao_pop_ok(const Params *p, i64 b, i64 k, i64 act,
                       const i8 *done)
{
    if (k == -1 || done[k])
        return 1;
    i64 inst = p->det_irs_inst[b];
    if (inst <= 0 || act <= 0)
        return 1;
    const i64 *ih = (const i64 *)(uintptr_t)p->det_ptrs[b * 4 + 0];
    i64 hits = ih[k % p->nw];
    return (double)(hits * act) <= p->low_cutoff[b] * (double)inst;
}

/* epoch-crossing poll + windowed IRS snapshots + aging
 * (epoch.poll_epochs for one row) */
static void ciao_poll_row(const Params *p, i64 b, i64 act,
                          int *lowp, int *highp)
{
    const i64 nw = p->nw;
    i64 it = p->det_inst_total[b];
    const i64 *vh = (const i64 *)(uintptr_t)p->det_ptrs[b * 4 + 1];
    i64 nlow = it / p->low_epoch[b];
    *lowp = nlow != p->low_idx[b];
    if (*lowp) {
        p->low_idx[b] = nlow;
        i64 win = it - p->low_base_inst[b];
        if (win < 1)
            win = 1;
        for (i64 w = 0; w < nw; w++) {
            i64 cur = vh[p->wid_sets[w]];
            p->low_snap_hits[b * nw + w] =
                cur - p->low_base_hits[b * nw + w];
            p->low_base_hits[b * nw + w] = cur;
        }
        p->low_snap_win[b] = win;
        p->low_snap_act[b] = act;
        p->low_base_inst[b] = it;
    }
    i64 nhigh = it / p->high_epoch[b];
    *highp = nhigh != p->high_idx[b];
    if (*highp) {
        p->high_idx[b] = nhigh;
        i64 win = it - p->high_base_inst[b];
        if (win < 1)
            win = 1;
        for (i64 w = 0; w < nw; w++) {
            i64 cur = vh[p->wid_sets[w]];
            p->high_snap_hits[b * nw + w] =
                cur - p->high_base_hits[b * nw + w];
            p->high_base_hits[b * nw + w] = cur;
        }
        p->high_snap_win[b] = win;
        p->high_snap_act[b] = act;
        p->high_base_inst[b] = it;
        p->high_crossings[b] += 1;
        if (p->aging_high[b] &&
                p->high_crossings[b] % p->aging_high[b] == 0) {
            p->det_irs_inst[b] /= 2;
            i64 *ih = (i64 *)(uintptr_t)p->det_ptrs[b * 4 + 0];
            for (i64 w = 0; w < nw; w++)
                ih[w] /= 2;
        }
    }
}

/* Algorithm 1 lines 4-19: pop at most one stalled and one isolated
 * warp, newest first (epoch.ciao_low_tick for one row) */
static void ciao_low_row(const Params *p, i64 b, i64 act)
{
    const i64 n = p->n, le = p->list_entries;
    const i8 *done = p->done + b * n;
    i8 *al = p->allowed_pl + b * n;
    i8 *is = p->isolated_pl + b * n;
    i64 *pair = p->pair_list + b * le * 2;
    i64 sl = p->stall_len[b];
    if (sl > 0) {
        i64 w = p->ciao_stall[b * n + sl - 1];
        if (ciao_pop_ok(p, b, pair[(w % le) * 2 + 1], act, done)) {
            p->stall_len[b] = sl - 1;
            al[w] = 1;
            pair[(w % le) * 2 + 1] = -1;
        }
    }
    /* a warp stalled while isolated must reactivate first — `allowed`
     * is read after the stall pop, like the scalar order */
    i64 il = p->iso_len[b];
    if (il > 0) {
        i64 w = p->ciao_iso[b * n + il - 1];
        if (al[w] &&
                ciao_pop_ok(p, b, pair[(w % le) * 2 + 0], act, done)) {
            p->iso_len[b] = il - 1;
            is[w] = 0;
            pair[(w % le) * 2 + 0] = -1;
        }
    }
}

/* Algorithm 1 lines 20-28: walk active warps by descending high-epoch
 * IRS, take at most one isolate/stall action (epoch.ciao_high_tick) */
static void ciao_high_row(const Params *p, i64 b)
{
    const i64 n = p->n, nw = p->nw, le = p->list_entries;
    const i8 *done = p->done + b * n;
    i8 *al = p->allowed_pl + b * n;
    i8 *is = p->isolated_pl + b * n;
    i64 *pair = p->pair_list + b * le * 2;
    const i64 *interf = (const i64 *)(uintptr_t)p->det_ptrs[b * 4 + 2];
    const i64 *hits = p->high_snap_hits + b * nw;
    i64 scored[n];
    i64 na = 0;
    for (i64 i = 0; i < n; i++)
        if (al[i] && !done[i])
            scored[na++] = i;
    if (na <= 1) /* never act on the last active warp */
        return;
    /* stable sort by descending snapshot hits (== descending IRS:
     * within a row the snapshot is hits * (act/win), one positive
     * scale), ties by warp id */
    for (i64 i = 1; i < na; i++) {
        i64 o = scored[i];
        i64 key = -hits[o % nw];
        i64 j = i - 1;
        while (j >= 0 && -hits[scored[j] % nw] > key) {
            scored[j + 1] = scored[j];
            j--;
        }
        scored[j + 1] = o;
    }
    i64 act = p->high_snap_act[b], win = p->high_snap_win[b];
    int mp = p->mode_p[b], mt = p->mode_t[b];
    for (i64 r = 0; r < na; r++) {
        i64 i = scored[r];
        i64 h = hits[i % nw];
        if (!((double)(h * act) > p->high_cutoff[b] * (double)win))
            break; /* sorted descending: nothing further exceeds */
        i64 j = interf[i % le];
        if (j == -1 || j == i || done[j])
            continue;
        if (mp && !is[j] && al[j]) {
            is[j] = 1;
            pair[(j % le) * 2 + 0] = i;
            p->ciao_iso[b * n + p->iso_len[b]] = j;
            p->iso_len[b] += 1;
            return;
        }
        if (mt && al[j] && (is[j] || !mp)) {
            al[j] = 0;
            pair[(j % le) * 2 + 1] = i;
            p->ciao_stall[b * n + p->stall_len[b]] = j;
            p->stall_len[b] += 1;
            return;
        }
    }
}

/* Service one epoch boundary in-stepper (the per-row equivalent of
 * BatchedSMEngine._epoch_batch). Returns 0 when the row's policy is an
 * unknown subclass (F_OBJECT) and must pause into Python instead.
 * `anchor` advances the next-trigger table (epoch pauses do, throttle
 * stretches do not, like the scalar loop). */
static int service_epoch(const Params *p, i64 b, int anchor, i64 cycle,
                         i64 li)
{
    i64 fam = p->fam[b];
    if (fam == F_OBJECT)
        return 0;
    p->det_inst_total[b] = li;
    p->det_irs_inst[b] = li - p->irs_off[b];
    if (fam == F_CCWS) {
        ccws_tick_row(p, b);
    } else if (fam == F_STATP) {
        statp_tick_row(p, b, cycle);
    } else if (fam == F_CIAO) {
        const i64 n = p->n;
        const i8 *done = p->done + b * n;
        const i8 *al = p->allowed_pl + b * n;
        i64 act = 0;
        for (i64 i = 0; i < n; i++)
            act += al[i] && !done[i];
        if (act < 1)
            act = 1;
        int low = 0, high = 0;
        ciao_poll_row(p, b, act, &low, &high);
        if (low)
            ciao_low_row(p, b, act);
        if (high)
            ciao_high_row(p, b);
    }
    p->irs_off[b] = li - p->det_irs_inst[b]; /* aging moves it */
    refresh_row(p, b);
    if (anchor) {
        i64 lo = p->low_epoch[b];
        i64 nxt = (li / lo + 1) * lo;
        if (p->stride_ok[b] && fam == F_CIAO
                && p->stall_len[b] + p->iso_len[b] == 0) {
            i64 hi = p->high_epoch[b];
            nxt = (li / hi + 1) * hi;
        }
        p->next_epoch[b] = nxt;
    }
    return 1;
}

/* record one timeline sample (BatchedSMEngine._timeline_rows) */
static void service_timeline(const Params *p, i64 b, i64 cycle, i64 instr)
{
    const i64 n = p->n;
    const i8 *al = p->allowed_pl + b * n;
    i64 na = 0;
    for (i64 i = 0; i < n; i++)
        na += al[i];
    i64 k = p->tl_n[b];
    if (k < p->tl_cap) { /* capacity-proved; guard against corruption */
        i64 dc = cycle - p->tl_last_cycle[b];
        if (dc < 1)
            dc = 1;
        p->tl_cycle[b * p->tl_cap + k] = cycle;
        p->tl_dipc[b * p->tl_cap + k] =
            (double)(instr - p->tl_last_instr[b]) / (double)dc;
        p->tl_act[b * p->tl_cap + k] = na;
        p->tl_n[b] = k + 1;
    }
    p->tl_last_instr[b] = instr;
    p->tl_last_cycle[b] = cycle;
    p->window_mark[b] += p->timeline_every;
}

/* warp retirement for the known kinds (BatchedSMEngine._warp_done_rows:
 * Best-SWL / statPCAL released-set rotation); the caller has already
 * flipped done/avail and handles WD_OBJECT by pausing */
static void warp_done_row(const Params *p, i64 b, i64 wid)
{
    const i64 n = p->n;
    i64 kind = p->wd_kind[b];
    p->remaining[b] -= 1;
    if (kind == WD_SWL) {
        i8 *al = p->allowed_pl + b * n;
        if (al[wid]) {
            al[wid] = 0;
            i64 nx = p->swl_next[b];
            if (nx < n) {
                al[nx] = 1;
                p->swl_next[b] = nx + 1;
                p->avail[b * n + nx] = !p->done[b * n + nx];
            }
        }
    } else if (kind == WD_STATP) {
        i8 *bm = p->sp_base + b * n;
        if (bm[wid]) {
            bm[wid] = 0;
            i64 nx = p->swl_next[b];
            if (nx < n) {
                bm[nx] = 1;
                p->swl_next[b] = nx + 1;
            }
            i8 *al = p->allowed_pl + b * n;
            i8 *bp = p->bypass_pl + b * n;
            i8 *avail = p->avail + b * n;
            i8 *byp = p->byp + b * n;
            const i8 *done = p->done + b * n;
            int ba = p->sp_bypass[b];
            for (i64 i = 0; i < n; i++) {
                al[i] = ba || bm[i];
                bp[i] = ba ? !bm[i] : 0;
                avail[i] = al[i] && !done[i];
                byp[i] = bp[i];
            }
        }
    }
}

static void run_cell(const Params *p, i64 b)
{
    const i64 n = p->n, L = p->L, P = p->P;
    i64 *ready = p->ready + b * n;
    i64 *op_idx = p->op_idx + b * n;
    i64 *n_ops = p->n_ops + b * n;
    i64 *pend = p->pend + b * n * P;
    i8 *done = p->done + b * n;
    i8 *avail = p->avail + b * n;
    i8 *iso = p->iso + b * n;
    i8 *byp = p->byp + b * n;
    const i64 *toks = p->toks + p->u_of[b] * n * L;
    i64 *l1_tags = p->l1_tags + b * p->nf;
    i64 *l1_owners = p->l1_owners + b * p->nf;
    i64 *l1_stamp = p->l1_stamp + b * p->nf;
    i8 *l1_reused = p->l1_reused + b * p->nf;
    i64 *smem_tags = p->smem_tags + b * p->nrb;
    i64 *smem_owner = p->smem_owner + b * p->nrb;
    /* post-L1 planes are per hierarchy: rows of a multi-SM cell share
     * them (only one SM phase is runnable at a time, so the cached
     * l2_tick never races another row) */
    const i64 m = p->mem_of[b];
    i64 *l2_tags = p->l2_tags + m * p->l2nf;
    i64 *l2_stamp = p->l2_stamp + m * p->l2nf;
    i64 *dram_free = p->dram_free + m * p->dram_channels;
    i64 *score = p->score_ptrs[b]
        ? (i64 *)(uintptr_t)p->score_ptrs[b] : (i64 *)0;
    i64 cycle = p->cycle[b], li = p->li[b], instr = p->instr[b];
    i64 last_wid = p->last_wid[b];
    i64 tick = p->tick[b], l2_tick = p->l2_tick[m];
    i64 rb = p->region_blocks[b];
    const i64 until = p->until[b];
    /* this row's config-plane knobs, hoisted out of the hot loop */
    const i64 lat_l1 = p->lat_l1[b], lat_smem = p->lat_smem[b];
    const i64 lat_migrate = p->lat_migrate[b], lat_l2 = p->lat_l2[b];
    const i64 lat_dram = p->lat_dram[b], dram_gap = p->dram_gap[b];
    const i64 low_epoch = p->low_epoch[b];
    i64 flags = 0;

    for (;;) {
        if (cycle >= until) { /* slice boundary / cycle cap */
            flags = P_SLICE;
            break;
        }
        /* pick a warp: greedy (keep last), else oldest ready & allowed */
        i64 wid = last_wid;
        if (wid < 0 || !avail[wid] || ready[wid] > cycle) {
            i64 w = -1;
            for (i64 i = 0; i < n; i++)
                if (avail[i] && ready[i] <= cycle) { w = i; break; }
            if (w >= 0) {
                wid = last_wid = w;
            } else {
                /* fused event skip: jump to the earliest wake-up */
                i64 best = HUGE_T, w2 = -1;
                for (i64 i = 0; i < n; i++)
                    if (avail[i] && ready[i] < best) {
                        best = ready[i];
                        w2 = i;
                    }
                if (w2 < 0) { /* everything throttled */
                    if (p->fam[b] == F_OBJECT) {
                        flags = P_THROTTLE;
                        break;
                    }
                    /* advance to let epochs fire, service in-stepper
                     * (no re-anchor of next_epoch, like the scalar
                     * loop), then retry selection; the slice check
                     * above bounds the stretch */
                    cycle += low_epoch;
                    li += low_epoch;
                    service_epoch(p, b, 0, cycle, li);
                    continue;
                }
                if (best >= until) {
                    /* clamp to the slice boundary, like the scalar
                     * advance(); the next phase resumes from here */
                    cycle = until;
                    flags = P_SLICE;
                    break;
                }
                cycle = best;
                if (last_wid >= 0 && avail[last_wid] &&
                        ready[last_wid] <= best)
                    wid = last_wid; /* greedy still wins the tie */
                else
                    wid = last_wid = w2;
            }
        }
        i64 tok = toks[wid * L + op_idx[wid]];
        i64 adv;
        if (tok >= 0) { /* memory instruction */
            li += 1;
            i64 line = tok >> p->line_shift;
            int vta_hit = 0;
            i64 lat = -1; /* -1 == "to the post-L1 stage" */
            if (byp[wid]) { /* statPCAL bypass */
                p->cnt_bypass[b] += 1;
            } else if (iso[wid]) { /* CIAO-P smem redirection */
                if (rb > 0) {
                    i64 idx = line % rb;
                    i64 old = smem_tags[idx];
                    if (old == line) {
                        p->cnt_smem_hit[b] += 1;
                        lat = lat_smem;
                    } else {
                        if (old >= 0) {
                            p->cnt_smem_evictions[b] += 1;
                            i64 owner = smem_owner[idx];
                            if (owner != wid)
                                vta_insert(p, b, owner, old, wid);
                        }
                        if (vta_probe(p, b, wid, line))
                            vta_hit = 1;
                        /* migration: single-copy coherence */
                        i64 base1 = l1_set(p, line) * p->l1_ways;
                        i64 f = -1;
                        for (i64 g = base1; g < base1 + p->l1_ways; g++)
                            if (l1_tags[g] == line) { f = g; break; }
                        if (f >= 0) {
                            l1_tags[f] = -1;
                            l1_owners[f] = -1;
                            p->cnt_smem_migrate[b] += 1;
                            lat = lat_migrate;
                        } else {
                            p->cnt_smem_miss[b] += 1;
                        }
                        smem_tags[idx] = line;
                        smem_owner[idx] = wid;
                    }
                }
            } else { /* L1D path */
                i64 base1 = l1_set(p, line) * p->l1_ways;
                i64 f = -1;
                for (i64 g = base1; g < base1 + p->l1_ways; g++)
                    if (l1_tags[g] == line) { f = g; break; }
                if (f >= 0) { /* L1D hit */
                    p->cnt_l1_hit[b] += 1;
                    l1_reused[f] = 1;
                    l1_stamp[f] = tick++;
                    lat = lat_l1;
                } else { /* miss: probe VTA, fill with stamp-LRU victim */
                    p->cnt_l1_miss[b] += 1;
                    if (vta_probe(p, b, wid, line))
                        vta_hit = 1;
                    i64 vic = base1;
                    i64 bs = l1_stamp[base1];
                    for (i64 g = base1 + 1; g < base1 + p->l1_ways; g++)
                        if (l1_stamp[g] < bs) {
                            bs = l1_stamp[g];
                            vic = g;
                        }
                    i64 old = l1_tags[vic];
                    if (old >= 0) {
                        p->cnt_evictions[b] += 1;
                        i64 owner = l1_owners[vic];
                        if ((l1_reused[vic] || !p->reuse_filter) &&
                                owner != wid)
                            vta_insert(p, b, owner, old, wid);
                    }
                    l1_tags[vic] = line;
                    l1_owners[vic] = wid;
                    l1_reused[vic] = 0;
                    l1_stamp[vic] = tick++;
                }
            }
            if (lat < 0) { /* post-L1: L2 tags + DRAM queueing */
                i64 base2 = (line % p->l2_sets) * p->l2_ways;
                i64 f2 = -1;
                for (i64 g = base2; g < base2 + p->l2_ways; g++)
                    if (l2_tags[g] == line) { f2 = g; break; }
                if (f2 >= 0) { /* L2 hit */
                    p->l2_hits[b] += 1;
                    lat = lat_l2;
                } else { /* L2 miss -> DRAM channel queue */
                    f2 = base2;
                    i64 bs = l2_stamp[base2];
                    for (i64 g = base2 + 1; g < base2 + p->l2_ways; g++)
                        if (l2_stamp[g] < bs) {
                            bs = l2_stamp[g];
                            f2 = g;
                        }
                    l2_tags[f2] = line;
                    p->l2_misses[b] += 1;
                    i64 ch = (line >> 2) % p->dram_channels;
                    i64 start = cycle > dram_free[ch] ? cycle
                                                      : dram_free[ch];
                    dram_free[ch] = start + dram_gap;
                    p->dram_requests[m] += 1;
                    p->cnt_dram_reqs[b] += 1;
                    lat = lat_dram + start - cycle;
                }
                l2_stamp[f2] = l2_tick++;
            }
            if (vta_hit && score) /* CCWS on_mem_event("vta_hit") */
                score[wid] += p->score_bump[b];
            i64 done_t = cycle + lat;
            if (tok & 1) { /* dependent use: block until it returns */
                ready[wid] = done_t;
            } else { /* hit-under-miss up to max_mlp outstanding */
                i64 *pd = pend + wid * P;
                i64 mi = 0;
                for (i64 k2 = 1; k2 < P; k2++)
                    if (pd[k2] < pd[mi]) mi = k2;
                pd[mi] = done_t; /* overwrite a stale (<= cycle) slot */
                i64 outstanding = 0, earliest = HUGE_T;
                for (i64 k2 = 0; k2 < P; k2++)
                    if (pd[k2] > cycle) {
                        outstanding += 1;
                        if (pd[k2] < earliest)
                            earliest = pd[k2];
                    }
                ready[wid] = outstanding >= p->max_mlp ? earliest
                                                       : cycle + 1;
            }
            adv = 1;
            cycle += 1;
        } else { /* batched ALU run up to the next memory instruction */
            adv = -tok;
            li += adv;
            cycle += adv;
            ready[wid] = cycle;
        }
        i64 pn = ++op_idx[wid];
        instr += adv;
        flags = 0;
        int fin = 0;
        if (pn >= n_ops[wid]) {
            done[wid] = 1;
            avail[wid] = 0;
            if (last_wid == wid)
                last_wid = -1;
            p->last_done_wid[b] = wid;
            if (p->wd_kind[b] == WD_OBJECT) {
                flags |= P_WARPDONE;
            } else {
                warp_done_row(p, b, wid);
                if (p->remaining[b] == 0)
                    fin = 1; /* finalize after epoch/timeline below */
            }
        }
        /* once any pause pends for Python, later checks on this
         * dispatch must pause too — the drain replays them in the
         * scalar order (warp-done, epoch, timeline) */
        if (li >= p->next_epoch[b]) {
            if (flags || !service_epoch(p, b, 1, cycle, li))
                flags |= P_EPOCH;
        }
        if (instr >= p->window_mark[b]) {
            if (flags)
                flags |= P_TIMELINE;
            else
                service_timeline(p, b, cycle, instr);
        }
        if (fin)
            flags |= P_FINALIZE;
        if (flags)
            break;
    }
    p->pause[b] = flags;
    p->cycle[b] = cycle;
    p->li[b] = li;
    p->instr[b] = instr;
    p->last_wid[b] = last_wid;
    p->tick[b] = tick;
    p->l2_tick[m] = l2_tick;
}

void step_cells(const Params *p)
{
    for (i64 b = 0; b < p->B; b++) {
        if (!p->live[b] || !p->runnable[b] || p->pause[b])
            continue;
        run_cell(p, b);
    }
}
