from .weedfs import WeedFS

__all__ = ["WeedFS"]
