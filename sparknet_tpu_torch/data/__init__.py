"""Datasets, loaders, preprocessing and the τ-round sampler (copies of the
JAX package's data modules, streaming ingest and bucket stores aside)."""
from .cifar import CifarLoader  # noqa: F401
from .mnist import MnistLoader  # noqa: F401
from .adult import AdultLoader  # noqa: F401
from .imagenet import ShardedTarLoader, load_label_map, list_shards  # noqa: F401
from .dataset import ArrayDataset, RoundSampler  # noqa: F401
from .preprocess import (DefaultPreprocessor, ImagePreprocessor,  # noqa: F401
                         compute_mean_image, to_nhwc)
