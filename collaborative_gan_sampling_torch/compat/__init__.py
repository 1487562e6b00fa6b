"""Migration from the reference: its flags and its TF1 checkpoints.

Counterpart of ``collaborative_gan_sampling_tpu/compat/``. The reference
runs per-experiment scripts with its own flag names (``--mode``,
``--rollout_steps``, ``--rollout_rate``, ``--rejection_gamma``, ...);
``main_synthetic``, ``main_mnist`` and ``main_celeba`` take those names and
map them onto the config (``_shared.py``), with ``--device`` beyond them:

    python -m collaborative_gan_sampling_torch.compat.main_synthetic \
        --mode benchmark --rollout_steps 10 --rollout_rate 0.1
    python -m collaborative_gan_sampling_torch.compat.main_mnist --mode train
    python -m collaborative_gan_sampling_torch.compat.main_celeba \
        --mode collab --device cpu

``tf1_import`` converts the reference's trained ``tf.train.Saver``
checkpoints into the port's checkpoints (``cli import-tf1 --config celeba
tf1=/path/to/ckpts``), ``tf1_export`` writes the other way, and
``tf1_graph`` rebuilds the reference's D graph and refinement loop from
exported weights. TensorFlow is imported only by the reader, the writer
and the graph.
"""
