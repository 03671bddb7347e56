"""Data and tensor parallelism on ``torch.distributed`` (counterpart of
``team_tpu/parallel``): one process per device, process groups over a
``("data",)`` or ``("data", "model")`` mesh, and the collectives they use."""

from team_tpu_torch.parallel.mesh import MeshContext, make_mesh, maybe_init_distributed  # noqa: F401
