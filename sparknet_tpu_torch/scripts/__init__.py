"""The port's studies and tools, one module each, run as
`python -m sparknet_tpu_torch.scripts.<name>`: the counterparts of the JAX
package's `scripts/`.

- `shard_imagenet`: re-shard an ILSVRC2012 tar-of-tars and a flat val tar
  into shuffled JPEG tar shards and label files (byte-equal to the JAX
  script's for the same input and seed);
- `parity_synth`: the cifar10_quick recipe, 4000 iterations on synthetic
  CIFAR, serial SGD against 8 workers averaging every τ = 10 steps;
- `parity_caffenet`: the bvlc_reference_caffenet recipe (b256 a worker,
  τ = 5, bfloat16) on a synthetic 64-class JPEG corpus, serial against 8
  workers, with the mean subtraction and the 227 crop on the card;
- `soak_stream`: thousands of τ-rounds through the streaming ingest path,
  tracking host RSS;
- `metrics_summary`: `obs.summary`'s console for a checkout without an
  install;
- `elastic_momentum_ab`: the A/B of the elastic resume's momentum policy
  on gloo CPU ranks.

The studies run on the CUDA card unless given `--device cpu`, and raise
before they start when there is no card. Their initial weights come from
seeded torch generators, so their curves are the port's own. `study`
holds what the two parity studies share: W workers' rounds on one card.
"""
