"""One module per traffic kind: ``setup(run)``, ``window(run, state)``,
``outputs(run, state)``, ``check(run, outputs)`` and ``control(run, outputs)``.
A workload file names its kind and holds the kind's parameters."""
