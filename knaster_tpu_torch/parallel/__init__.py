"""Port of knaster_tpu/parallel: voice banks, and voice banks sharded over devices."""

from .mesh import Mesh, MeshVoiceBank, ShardedVoiceBank, make_mesh  # noqa: F401
