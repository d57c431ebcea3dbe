from repro_torch.distributed import rules  # noqa: F401
from repro_torch.distributed.act_sharding import activation_policy, constrain  # noqa: F401
from repro_torch.distributed.compat import abstract_mesh, make_mesh  # noqa: F401
