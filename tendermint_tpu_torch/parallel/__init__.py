"""Device meshes of the port: the multi-card verify and hash lanes
(`mesh.py`) and the multi-host seam over `torch.distributed`
(`distributed.py`)."""
