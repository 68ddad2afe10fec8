"""Parallelism (port of ``demucs_tpu/parallel``): ``rows`` (which rows of a
data-parallel global batch this rank holds, for the train-time draws),
``sharded`` (segments and bag members over several devices) and ``tp``
(the tensor-parallel cross-transformer)."""
