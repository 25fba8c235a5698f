from repro_torch.data.synthetic import (TransferTask, lm_batches,
                                       transfer_image_batches)

__all__ = ["TransferTask", "lm_batches", "transfer_image_batches"]
