from halogen_tpu_torch.cli.main import main
