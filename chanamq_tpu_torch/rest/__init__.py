"""L6: localhost admin REST API."""

from .admin import AdminServer

__all__ = ["AdminServer"]
