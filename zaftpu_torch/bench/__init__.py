"""The port's bench suite (:mod:`zaftpu_torch.bench.harness`)."""
