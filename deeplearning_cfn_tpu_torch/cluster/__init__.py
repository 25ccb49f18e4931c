"""The cluster plane of the port: the queue, the contract, elasticity and the
live-reshard manager (``deeplearning_cfn_tpu/cluster``'s counterparts)."""

from deeplearning_cfn_tpu_torch.cluster.queue import InMemoryQueue, Message, RendezvousQueue  # noqa: F401
from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract  # noqa: F401
