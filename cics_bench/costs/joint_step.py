"""Kernel #3, one joint spatio-temporal step with the fleet-coupled shift
update (``joint_step.cu``, the fused route ``joint_step_s_kernel`` or the
split route ``joint_step_kernel`` then ``s_project_kernel``): the
operations and bytes of its function, counted as ``pgd_epoch``'s, with the
halvings of the rows' projections (``halvings``) and of each rollout's
shift projection over its clusters (``shift_halvings``).

  per hour: the box 10 and its feasibility compare 1, pow 5, softmax 4,
  gcoef 4, g_d 1, the g_s term 2, z 2, final clip 3, and 3 a halving;
  per row: tau + s, t24 and tau_s / 24 4, the feasibility compares 2,
  g_s / 24 1, the reductions (sum ub, softmax max and sum, g_s, box max
  and min, bracket min and max, one sum a halving), and 3 scalar ops a
  halving and 4 more;
  per cluster in the shift update: z 2, final clip 3, and 3 a halving; per
  rollout the bracket's four reductions, its two differences, one sum and
  3 scalar ops a halving, and nu 2.

Bytes: 7 wide and 10 slim float32 inputs a row read once (lo_s and ub_s
among them), one wide and one slim output written once, and lr_s once a
rollout."""

NAME = "joint_step"
KERNELS = ("joint_step_s_kernel", "joint_step_kernel", "s_project_kernel")
TARGET = ("repro_torch.kernels.vcc_pgd.kernel", "joint_step_s_cuda")
HALVINGS = ("joint_row", "joint_shift")


def shape(args, kwargs):
    """The launch's sizes: d (B n, H) first, n clusters a rollout."""
    rows, H = args[0].shape
    return {"rows": int(rows), "H": int(H), "n": int(kwargs["n"])}


def flops(rows: int, H: int, n: int, halvings: float,
          shift_halvings: float) -> float:
    P, Q = halvings, shift_halvings
    B = rows // n
    step = rows * ((32 + 3 * P) * H + (8 + P) * (H - 1) + 3 * P + 11)
    shift = B * ((5 + 3 * Q) * n + (4 + Q) * (n - 1) + 3 * Q + 4)
    return step + shift


def nbytes(rows: int, H: int, n: int) -> float:
    return 4 * rows * (8 * H + 11) + 4 * (rows // n)
