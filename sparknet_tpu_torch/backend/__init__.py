"""The second backend: serialized dataflow graphs (GraphDef JSON, TF .pb)
under the NetInterface API — the counterpart of `sparknet_tpu/backend/`."""
from .graphdef import GraphDef, NodeDef  # noqa: F401
from .graph_net import GraphNet  # noqa: F401
from .builder import (GraphBuilder, build_alexnet_graph,  # noqa: F401
                      build_mnist_graph)
