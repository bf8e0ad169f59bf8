"""The port's tools, each the counterpart of a script in ``scripts/``:
``python -m fast_srgan_torch.scripts.<name>`` for ``export_model``,
``evaluate``, ``interp_checkpoints``, ``convert_checkpoint`` and
``plot_metrics``, and the measurement scripts ``eval_int8``, ``bench_4k``,
``bench_serve``, ``train_throughput``, ``profile_model`` and ``soak``
(``measure.py``: what they share). Each ``main(argv)`` also runs
in-process."""
