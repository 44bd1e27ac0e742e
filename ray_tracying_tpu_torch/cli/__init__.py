from ray_tracying_tpu_torch.cli.main import main, parse_args
