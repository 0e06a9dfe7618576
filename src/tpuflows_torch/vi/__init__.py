from tpuflows_torch.vi.elbo import elbo, vi_sample

__all__ = ["elbo", "vi_sample"]
