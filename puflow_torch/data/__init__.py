"""Input pipelines: PU1K and PU-GAN (h5), PUGeo (tfrecord shards, read by
the TF-free codec), augmentation, the synthetic sampler.

The port's own copies of `puflow_tpu.data`'s numpy modules (the port
imports nothing of `puflow_tpu`); they hand numpy batches to the trainer.
"""
