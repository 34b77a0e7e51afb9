"""The dense path's linear algebra: port of ``marlin_tpu/linalg`` (blocked
LU, Cholesky, inverse and solve on a mesh's row stripes, CholeskyQR2 and
least squares, Lanczos and the Gramian SVD). The per-device work is
cuSOLVER and cuBLAS through ``torch.linalg`` and ``torch.matmul``, the
communication ``torch.distributed``; no hand-written kernel. The "local"
modes (and the SVD's "local-svd" and "local-eigs") put the whole matrix
on every rank by design, as the reference's local modes gather it to
one host; "dist" mode works on row stripes."""

from .cholesky import cholesky_decompose, cholesky_factor_array
from .inverse import inverse
from .lanczos import symmetric_eigs
from .lu import lu_decompose, lu_factor_array, unpack_lu
from .qr import lstsq, qr_decompose, qr_factor_array
from .solve import solve
from .svd import SVDResult, compute_svd
