"""The port's counterparts of the reference's ``examples/``: runnable end
to end with ``python -m repro_torch.examples.<name>`` (``quickstart``,
``serve_batched``, ``train_100m``). Each ``main(argv)`` returns what it
printed."""
