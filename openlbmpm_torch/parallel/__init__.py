"""Domain decomposition of the 2-D steps over a mesh of shards (K12a and
K12b): the counterpart of ``openlbmpm_tpu/parallel/mesh.py`` and of the
JAX sharded builders' halo exchange.  ``mesh`` holds the meshes
(``LocalMesh``, ``ProcessMesh``), ``ppermute``, the frame exchange and the
sharded state; ``dryrun`` the multi-device entry point.  The builders are
``kernels/csf.py::build_csf_sharded_step`` and ``kernels/single.py::
build_single_sharded_step``."""

from .mesh import (Frame, LocalGrid, LocalMesh, ProcessMesh, ShardedState,
                   ShardedStep, exchange, gather_domain, make_mesh, ppermute,
                   shard_domain)

__all__ = ["Frame", "LocalGrid", "LocalMesh", "ProcessMesh", "ShardedState",
           "ShardedStep", "exchange", "gather_domain", "make_mesh", "ppermute",
           "shard_domain"]
