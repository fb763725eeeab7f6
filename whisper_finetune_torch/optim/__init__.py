from whisper_finetune_torch.optim.quantized import AdamW8bit, adamw_8bit

__all__ = ["AdamW8bit", "adamw_8bit"]
