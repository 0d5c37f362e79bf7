"""Process meshes over torch.distributed: one query processor a rank."""
