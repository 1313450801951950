"""aoclsparse_tpu_torch — the PyTorch + CUDA port of aoclsparse_tpu.

Same public names and semantics as the JAX package for what is ported so
far: CSR handles, hints and the planner, ``mv``/``dotmv`` through the
``bandt`` and ``segsum`` execution forms, and unpreconditioned CG. The band
form runs a hand-written CUDA kernel on Hopper (csrc/band_spmv.cu), built
with nvcc at first use; on CPU tensors it runs the kernel's plain PyTorch
version. Tensors go to ``cuda:0`` unless a device is named. ROADMAP.md lists
what is still to port.
"""

from .core.types import (  # noqa: F401
    AoclSparseError,
    DiagType,
    FillMode,
    FormatType,
    IluType,
    IndexBase,
    MatrixSort,
    MatrixType,
    MemoryPolicy,
    Operation,
    Order,
    Request,
    SorType,
    Status,
)
from .core.descr import Doid, GENERAL, MatrixDescriptor, get_doid, trans_doid  # noqa: F401
from .core.formats import CSR  # noqa: F401
from .core.matrix import (  # noqa: F401
    SparseMatrix,
    create_csr,
    destroy,
    export_csr,
    update_values,
)
from .core.auxiliary import set_precision_mode  # noqa: F401
from .core.context import get_context  # noqa: F401
from .kernels.registry import debug_dispatcher  # noqa: F401
from .ops import dotmv, mv  # noqa: F401
from .planner import optimize, set_mv_hint  # noqa: F401
from .solvers import pcg_solve  # noqa: F401

__version__ = "0.1.0"


def get_version() -> str:
    """aoclsparse_get_version analog."""
    return __version__
