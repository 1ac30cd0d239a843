"""Multi-device sampling on torch.distributed: the counterpart of the JAX
package's `parallel/`. `mesh.py` holds the ("dp", "sp", "tp") mesh and the
collectives, `tp.py` the tensor-parallel slicing of the UNet."""
