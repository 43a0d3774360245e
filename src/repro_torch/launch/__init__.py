"""Launch helpers of the port: meshes (the reference's ``launch/``)."""
