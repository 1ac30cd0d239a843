"""Multi-device sampling on torch.distributed (`mesh.py`): the counterpart of
the JAX package's `parallel/`. Tensor parallelism (the JAX package's
`parallel/tp.py`) is not ported yet (see ROADMAP.md)."""
