"""The user examples on the port, the JAX package's ``examples/`` with its
arguments and defaults plus ``--device`` (default ``cuda``; ``cpu`` runs the
kernels' plain PyTorch versions):

    python -m hnanosolver_tpu_torch.examples.fireball --frames 36 --out out_fire
    python -m hnanosolver_tpu_torch.examples.smoke_to_nvdb --frames 24 --out out_demo
    python -m hnanosolver_tpu_torch.examples.view_and_export --frames 12 --size 64
"""
