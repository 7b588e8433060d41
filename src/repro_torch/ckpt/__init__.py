from repro_torch.ckpt.checkpoint import (  # noqa: F401
    latest_step, restore_checkpoint, restore_reference_checkpoint,
    save_checkpoint)
