from .registry import ARCH_IDS, ALIASES, build_model, get_config, get_model  # noqa: F401
