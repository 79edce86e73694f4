from fdt_torch.eval.pr import TfConfAccumulator, calc_pr, gen_tp_fp, pr_curve, roc_curve

__all__ = ["calc_pr", "TfConfAccumulator", "gen_tp_fp", "pr_curve", "roc_curve"]
