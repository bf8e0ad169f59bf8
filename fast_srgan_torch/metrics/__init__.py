"""Image-quality metrics (PSNR / SSIM) on the tensors' device."""
