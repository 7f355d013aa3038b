"""Device meshes and the in-process collectives over them."""

from oap_mllib_tpu_torch.parallel.mesh import Mesh, get_mesh

__all__ = ["Mesh", "get_mesh"]
