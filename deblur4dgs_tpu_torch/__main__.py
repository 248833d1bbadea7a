from deblur4dgs_tpu_torch.cli import main

main()
