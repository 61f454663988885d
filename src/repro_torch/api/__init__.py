from repro_torch.api.agent import (  # noqa: F401
    ActAux,
    AgentSpec,
    LossAux,
    resolve_agent,
    validate_agent,
)
from repro_torch.api.runner import (  # noqa: F401
    RESULT_KEYS,
    SERVE_RESULT_KEYS,
    make_result,
    make_serve_result,
)
