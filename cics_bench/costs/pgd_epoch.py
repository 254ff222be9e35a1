"""Kernel #1, the fused VCC projected-gradient epoch (``pgd_epoch.cu``):
the operations and bytes of its function.

Operations count as the reference computes them: each add, multiply,
divide, min, max, exp and compare counts one, and a reduction over H hours
counts H - 1, however the kernel's lanes split it. The bisection of nu
counts the halvings these inputs need (``halvings``, the mean a row and
step, read from the reference's own projections): the kernel stops a
warp's bisection once no bracket end moves.

  per hour and step: pow 3, /temp 1, -max 1, exp 1, /sum 1, grad 5, z 2,
  final clip 3, and 3 a halving;
  per row and step: softmax max and sum and the bracket's min and max,
  2 (H - 1) each pair, one (H - 1) sum and 3 scalar ops a halving, 4 for
  the bracket and nu;
  per row once: the max ub / min lo bracket terms, 2 (H - 1).

Bytes: 6 wide and 5 slim float32 inputs read once, one wide output
written once."""

NAME = "pgd_epoch"
KERNELS = ("pgd_epoch_kernel",)
TARGET = ("repro_torch.kernels.vcc_pgd.kernel", "pgd_epoch_cuda")
HALVINGS = ("pgd_epoch",)


def shape(args, kwargs):
    """The launch's sizes from the wrapper's arguments (delta first)."""
    rows, H = args[0].shape
    return {"rows": int(rows), "H": int(H), "iters": int(kwargs["iters"])}


def flops(rows: int, H: int, iters: int, halvings: float) -> float:
    P = halvings
    per_hour = 17 + 3 * P
    per_row_step = (4 + P) * (H - 1) + 3 * P + 4
    return rows * (iters * (per_hour * H + per_row_step) + 2 * (H - 1))


def nbytes(rows: int, H: int, iters: int) -> float:
    return 4 * rows * (7 * H + 5)
