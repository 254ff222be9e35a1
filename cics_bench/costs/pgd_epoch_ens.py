"""Kernel #2, the CVaR ensemble epoch (``pgd_epoch_ens.cu``): the
operations and bytes of its function, counted as ``pgd_epoch``'s; the
member weights, which every lane of a row repeats alike, count once a row.

  per member, hour and step: pow 1, softmax 4, the two cost products 2,
  the two anchored accumulations 6;
  per hour and step: pi d tau24 2, eta_w and w_w 2, grad 5, z 2, final
  clip 3, and 3 a halving;
  per member, row and step: the four reductions 4 (H - 1), the cost 3, and
  the member weights 12;
  per row and step: the mean and scale 3, and the projection's scalar work
  as in ``pgd_epoch``; per row once: 2 (H - 1).

Bytes: 4 wide, 2 K-member wide and 6 slim float32 inputs read once, one
wide output written once."""

NAME = "pgd_epoch_ens"
KERNELS = ("pgd_epoch_ens_kernel",)
TARGET = ("repro_torch.kernels.vcc_pgd.kernel", "pgd_epoch_ens_cuda")
HALVINGS = ("pgd_epoch_ens",)


def shape(args, kwargs):
    """The launch's sizes: delta (rows, H) first, the members (B, K, n, H)
    second."""
    rows, H = args[0].shape
    return {"rows": int(rows), "H": int(H), "K": int(args[1].shape[1]),
            "iters": int(kwargs["iters"])}


def flops(rows: int, H: int, K: int, iters: int, halvings: float) -> float:
    P = halvings
    per_hour = 13 * K + 14 + 3 * P
    per_row_step = K * (4 * (H - 1) + 15) + 3 \
        + (2 + P) * (H - 1) + 3 * P + 4
    return rows * (iters * (per_hour * H + per_row_step) + 2 * (H - 1))


def nbytes(rows: int, H: int, K: int, iters: int) -> float:
    return 4 * rows * ((5 + 2 * K) * H + 6)
