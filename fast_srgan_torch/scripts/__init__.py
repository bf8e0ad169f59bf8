"""The port's tools, each the counterpart of a script in ``scripts/``:
``python -m fast_srgan_torch.scripts.<name>`` for ``export_model``,
``evaluate``, ``interp_checkpoints``, ``convert_checkpoint`` and
``plot_metrics``. Each ``main(argv)`` also runs in-process."""
