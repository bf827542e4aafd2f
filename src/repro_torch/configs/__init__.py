from .registry import ARCH_IDS, get, list_archs

__all__ = ["get", "list_archs", "ARCH_IDS"]
