"""Datasets, loaders, preprocessing, the τ-round sampler, streaming round
sources and the gs:// / s3:// clients (copies of the JAX package's data
modules)."""
from .cifar import CifarLoader  # noqa: F401
from .mnist import MnistLoader  # noqa: F401
from .adult import AdultLoader  # noqa: F401
from .imagenet import ShardedTarLoader, load_label_map, list_shards  # noqa: F401
from .dataset import ArrayDataset, RoundSampler  # noqa: F401
from .preprocess import (DefaultPreprocessor, ImagePreprocessor,  # noqa: F401
                         compute_mean_image, to_nhwc)
