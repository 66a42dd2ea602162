"""The port's GPT-3 response CLIs (``python -m vidil_tpu_torch.utils_gpt3.<cli>``)."""
