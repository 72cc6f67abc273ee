"""Training of the port: torch-exact Adam, the LR dicts, and the train and eval steps."""
