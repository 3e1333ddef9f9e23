"""Data parallelism over streams: parallel.mesh (make_mesh, shard_streams,
render_sharded)."""

from dsp_stuff_tpu_torch.parallel import mesh  # noqa: F401
