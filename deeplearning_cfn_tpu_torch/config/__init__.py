from deeplearning_cfn_tpu_torch.config.schema import (  # noqa: F401
    ClusterSpec,
    JobSpec,
    StorageSpec,
    NodePool,
    TimeoutSpec,
    ALLOWED_ACCELERATOR_TYPES,
)
from deeplearning_cfn_tpu_torch.config.template import load_template, render_template  # noqa: F401
