"""Training: optimizers, the train step and the fault-tolerant trainer
(port of ``src/repro/train``)."""
