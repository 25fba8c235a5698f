from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointManager, codec,
                                            load_pytree, restore_delta_store,
                                            save_delta_store, save_pytree)

__all__ = ["CheckpointCorruptError", "CheckpointManager", "codec",
           "save_pytree", "load_pytree", "save_delta_store",
           "restore_delta_store"]
