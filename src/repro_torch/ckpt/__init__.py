from repro_torch.ckpt.checkpoint import all_steps, latest_step, restore, save

__all__ = ["all_steps", "latest_step", "restore", "save"]
