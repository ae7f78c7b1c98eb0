"""admm_roofline_pct.deconv: the ADMM split-update and right-hand-side
kernels' share of their memory bound in a standalone solve (over-relaxed:
17 volumes a split update), which moves deconv_mvox_iter_s."""

from benchmark.readers import admm_roofline_pct

__all__ = ["COUNTERS", "read"]

COUNTERS = {"split_launches": ("microtipi_tpu_torch.ops.kernels.admm_split", "split_launches"),
            "rhs_launches": ("microtipi_tpu_torch.ops.kernels.admm_split", "rhs_launches")}


def read(ctx):
    return admm_roofline_pct(ctx, ctx.traffic["over_relax"])
