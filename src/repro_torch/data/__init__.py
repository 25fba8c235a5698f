from repro_torch.data.synthetic import lm_batches

__all__ = ["lm_batches"]
