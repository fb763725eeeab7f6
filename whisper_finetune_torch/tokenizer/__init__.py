from whisper_finetune_torch.tokenizer.languages import LANGUAGES, TO_LANGUAGE_CODE
from whisper_finetune_torch.tokenizer.tokenizer import WhisperTokenizer, get_tokenizer

__all__ = ["LANGUAGES", "TO_LANGUAGE_CODE", "WhisperTokenizer", "get_tokenizer"]
