"""Small string-keyed plugin registries (the rtos_sim idiom).

Every pluggable axis of the scenario engine — arrival models, execution-time
models, overhead models, protocols, schedulers, named scenarios — is one
:class:`Registry`: factories register under a short string key, configs name
the key plus keyword parameters, and :meth:`Registry.create` instantiates.
Unknown keys fail loudly with the list of registered alternatives, so a typo
in a scenario config is a one-line error instead of a silent default.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["Registry", "RegistryError"]


class RegistryError(KeyError):
    """Unknown registry key (carries the available alternatives)."""

    def __str__(self) -> str:  # KeyError quotes its arg; keep the message
        return self.args[0]


class Registry:
    """A string-keyed factory table.

    >>> ARRIVALS = Registry("arrival model")
    >>> @ARRIVALS.register("periodic")
    ... class Periodic: ...
    >>> ARRIVALS.create("periodic")
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._factories: dict[str, Callable[..., Any]] = {}

    def register(self, name: str, factory: Callable[..., Any] | None = None):
        """Register ``factory`` under ``name``; usable as a decorator."""
        if name in self._factories:
            raise ValueError(f"duplicate {self.kind} key {name!r}")

        def _add(f: Callable[..., Any]):
            self._factories[name] = f
            return f

        return _add if factory is None else _add(factory)

    def create(self, name: str, /, **params) -> Any:
        """Instantiate the factory registered under ``name``."""
        try:
            factory = self._factories[name]
        except KeyError:
            raise RegistryError(
                f"unknown {self.kind} {name!r}; available: {self.available()}"
            ) from None
        return factory(**params)

    def get(self, name: str) -> Callable[..., Any]:
        """The raw factory (without instantiating it)."""
        try:
            return self._factories[name]
        except KeyError:
            raise RegistryError(
                f"unknown {self.kind} {name!r}; available: {self.available()}"
            ) from None

    def available(self) -> list[str]:
        return sorted(self._factories)

    def __contains__(self, name: object) -> bool:
        return name in self._factories

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._factories))

    def __len__(self) -> int:
        return len(self._factories)
