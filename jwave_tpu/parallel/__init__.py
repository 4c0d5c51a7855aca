"""Multi-chip sharding layer (device mesh + SPMD transforms).

The reference has no distributed execution — its whole parallelism
inventory is intra-process ForkJoinPool fan-out (SURVEY.md §2.6). This
package is the new first-class layer this library adds: a `jax.sharding`
Mesh over the devices with

  * scale-sharded CWT (embarrassingly parallel scales axis),
  * batch sharding for many-signal workloads,
  * 2D/3D separable FWT/WPT with an all_to_all distributed transpose
    (rows local -> transpose -> columns local), and
  * time-sharded MODWT with ppermute halo exchange of filter-support
    boundary samples (compact-support analog of ring attention), and
  * a distributed four-step FFT (pfft) powering depth-unlimited
    time-sharded MODWT whose working set never leaves N/D per chip.
"""
from .mesh import make_mesh, initialize_distributed
from .pfft import pfft, pifft, pfft2, pifft2
from .sharded import (
    fwt_halo_sharded,
    fwt2d_tile_sharded,
    gather_pyramid,
    gather_pyramid_2d,
    batch_sharded,
    cwt_batch_scale_sharded,
    cwt_scale_sharded,
    ssq_scale_sharded,
    cwt_time_sharded,
    fwt2d_sharded,
    ifwt2d_sharded,
    fwt3d_sharded,
    ifwt3d_sharded,
    wpt3d_sharded,
    iwpt3d_sharded,
    modwt_halo_sharded,
    imodwt_halo_sharded,
    modwt_fft_sharded,
    imodwt_fft_sharded,
    modwt2d_sharded,
    imodwt2d_sharded,
    wpt2d_sharded,
    iwpt2d_sharded,
)

__all__ = [
    "make_mesh",
    "initialize_distributed",
    "batch_sharded",
    "cwt_scale_sharded",
    "ssq_scale_sharded",
    "cwt_batch_scale_sharded",
    "cwt_time_sharded",
    "fwt2d_sharded",
    "ifwt2d_sharded",
    "wpt2d_sharded",
    "iwpt2d_sharded",
    "fwt3d_sharded",
    "ifwt3d_sharded",
    "wpt3d_sharded",
    "iwpt3d_sharded",
    "modwt_halo_sharded",
    "fwt_halo_sharded",
    "fwt2d_tile_sharded",
    "gather_pyramid",
    "gather_pyramid_2d",
    "imodwt_halo_sharded",
    "modwt_fft_sharded",
    "imodwt_fft_sharded",
    "pfft",
    "pifft",
    "pfft2",
    "pifft2",
    "modwt2d_sharded",
    "imodwt2d_sharded",
]
