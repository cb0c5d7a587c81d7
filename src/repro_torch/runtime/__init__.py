from repro_torch.runtime.elastic import ElasticMeshManager  # noqa: F401
from repro_torch.runtime.health import StragglerWatchdog  # noqa: F401
