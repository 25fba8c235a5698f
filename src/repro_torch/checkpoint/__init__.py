from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointManager, codec,
                                            load_pytree, restore_delta_store,
                                            restore_spill_tier,
                                            save_delta_store, save_pytree,
                                            save_spill_tier)

__all__ = ["CheckpointCorruptError", "CheckpointManager", "codec",
           "save_pytree", "load_pytree", "save_delta_store",
           "restore_delta_store", "save_spill_tier", "restore_spill_tier"]
