"""Backend-neutral utilities of the port."""

from .summary import SummaryWriter  # noqa: F401
