"""Which device operations belong to which layer, by kernel name."""

from .tracetab import matcher

#: K1-K4, the port's hand-written pair-update kernels (csrc/).
PAIR_KERNELS = matcher("jacobi_rows", "theta_build", "rand_tail", "fused_pair")

#: The rand route's range-finder: cuSOLVER's Householder QR and LU
#: factorization kernels behind ``torch.linalg.qr`` / ``lu_factor``.
RANGE_FINDER = matcher("geqr", "getrf", "orgqr", "ungqr", "larf", "laswp")
