"""Training-side utilities of the port. Today only :mod:`.checkpoint`, the
part the coloring service checkpoints its streams through."""
