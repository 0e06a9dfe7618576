from tpuflows_torch.vi.elbo import VIResult, elbo, fit_vi, vi_log_q, vi_sample

__all__ = ["VIResult", "elbo", "fit_vi", "vi_log_q", "vi_sample"]
