"""Command-line tools of the port: the trainer, the serving benchmark and
the int8 rate probe (``python -m fpqvar_tpu_torch.tools.<name> --help``)."""
