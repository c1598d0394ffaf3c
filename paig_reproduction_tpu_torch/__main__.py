from paig_reproduction_tpu_torch.cli import main

main()
