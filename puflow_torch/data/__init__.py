"""Input pipelines: PU1K (h5), augmentation, the synthetic sampler.

The port's own copies of `puflow_tpu.data`'s numpy modules (the port
imports nothing of `puflow_tpu`); they hand numpy batches to the trainer.
"""
