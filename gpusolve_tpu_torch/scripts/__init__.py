"""The port's user scripts: ``parity`` (every engine against the float64
host solver), ``experiments`` (a backend × mode × size sweep) and
``plotter`` (a dumped solution against the analytic one); each runs as
``python -m gpusolve_tpu_torch.scripts.<name>``."""
