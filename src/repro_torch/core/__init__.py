from repro_torch.core.baselines import SYSTEMS, SystemPolicy, get_system  # noqa: F401
from repro_torch.core.daemon import DataLoadError, OutOfDeviceMemory  # noqa: F401
from repro_torch.core.dispatch import DISPATCH_POLICIES, NodeSnapshot  # noqa: F401
from repro_torch.core.engine import FunctionEngine, GPUFunction  # noqa: F401
from repro_torch.core.request import Data, DataType, Request  # noqa: F401
from repro_torch.core.runtime import ClusterRuntime, SageRuntime  # noqa: F401
