"""Stage 6: rendering at the solved poses, hand-masked metrics, LPIPS."""
from egogaussian_tpu_torch.eval.metrics import masked_psnr, masked_ssim, evaluate_metrics
from egogaussian_tpu_torch.eval.lpips import LPIPS, load_lpips_weights
from egogaussian_tpu_torch.eval.render_results import render_results, calculate_metric
