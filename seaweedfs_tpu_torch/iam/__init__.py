from .server import IamApiServer

__all__ = ["IamApiServer"]
