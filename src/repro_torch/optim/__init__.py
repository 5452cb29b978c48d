"""AdamW over the port's flat parameter dicts (``optim.adamw``)."""
