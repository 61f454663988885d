from repro_torch.api.runner import (  # noqa: F401
    SERVE_RESULT_KEYS,
    make_serve_result,
)
