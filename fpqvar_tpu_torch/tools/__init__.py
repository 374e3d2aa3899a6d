"""Command-line tools of the port: the offline pipeline (checkpoint
conversion, calibration, format search, GALT training), the trainer,
evaluation (the eval set, scoring, the quality ladder, the baseline
study), the serving benchmark and the int8 rate probe (``python -m
fpqvar_tpu_torch.tools.<name> --help``)."""
