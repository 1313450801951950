"""Distributed execution on torch.distributed: one process a rank, each
running the same call on its own block (the JAX package's parallel/,
which maps one call over a jax.sharding Mesh).

Start a run with `init_multiprocess` (backend "nccl", one card a rank, or
"gloo": CPU shards, or CUDA shards on a shared card staged through host
memory), take its mesh with `make_mesh` / `global_mesh`, place host arrays
with `put`, and read results with `fetch`. The local legs run the port's
kernels: the band halo SpMV and the halo Krylov loops on the group-window
kernel (#4), `cg_bandv_jit` on the band kernel (#1, #2), `dist_trsm` on the
form's own solve (#14 on a ``win`` form). `dryrun_multichip(n)` spawns n
CPU ranks and runs every path once.
"""

from .cg import (  # noqa: F401
    cg_bandv_jit,
    cg_bwd_jit,
    cg_ell_jit,
    dist_cg,
    dist_cg_bwd,
    dist_cg_bwd_halo,
    dist_cg_ell_halo,
    dist_cg_pipelined,
    prepare_dist_ell,
)
from .dryrun import World, dryrun_multichip, spawn_world, start_world  # noqa: F401
from .gmres import dist_gmres_bwd, dist_gmres_bwd_halo, gmres_bwd_jit  # noqa: F401
from .multiproc import global_mesh, init_multiprocess, process_count, process_index, shutdown  # noqa: F401
from .partition import nnz_balanced_bounds, pack_balanced_ell  # noqa: F401
from .placement import Mesh, P, Shard, fetch, mesh_is_multiprocess, put  # noqa: F401
from .precond import block_jacobi_inv  # noqa: F401
from .spgemm import (  # noqa: F401
    dist_spgemm_halo,
    dist_spgemm_numeric,
    dist_spgemm_rowpart,
    partition_products,
)
from .spmv import (  # noqa: F401
    compact_balanced,
    dist_spmm_bwd_halo,
    dist_spmm_ell_halo_plan,
    dist_spmv_balanced_halo,
    dist_spmv_bwd_halo,
    dist_spmv_bwd_halo_overlap,
    dist_spmv_ell,
    dist_spmv_ell_balanced,
    dist_spmv_ell_halo_plan,
    dist_spmv_ell_sharded_x,
    make_mesh,
    plan_general_halo,
    shard_ell,
)
from .sweeps import dist_ilu_apply, dist_symgs, dist_symgs_chain  # noqa: F401
from .trsm import dist_trsm  # noqa: F401
from .trsv import dist_trsm_pipeline, dist_trsv_levels, dist_trsv_pipeline  # noqa: F401
