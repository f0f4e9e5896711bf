from .gpt import GPT, GPTConfig  # noqa: F401
