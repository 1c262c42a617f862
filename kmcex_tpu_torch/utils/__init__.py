from kmcex_tpu_torch.utils.prefetch import prefetch_iterator

__all__ = ["prefetch_iterator"]
