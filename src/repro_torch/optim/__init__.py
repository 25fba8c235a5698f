from repro_torch.optim.optimizers import (apply_updates, apply_updates_mixed,
                                         clip_by_global_norm, init_opt_state,
                                         learning_rate)

__all__ = ["apply_updates", "apply_updates_mixed", "clip_by_global_norm",
           "init_opt_state", "learning_rate"]
