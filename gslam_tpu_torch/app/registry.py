"""Component registries and dataset dispatch by path extension.

Counterpart of ``gslam_tpu/app/registry.py``: a plugin is a registry
entry (a name -> factory mapping with decorator registration), and a
dataset path's extension selects its player, as the reference's
``REGISTER_DATASET(Class, "ext")`` does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple


class Registry:
    """Name -> factory registry with decorator registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._factories: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str
                 ) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
        def deco(factory: Callable[..., Any]) -> Callable[..., Any]:
            key = name.lower()
            if key in self._factories:
                raise KeyError(f"{self.kind} {name!r} already registered")
            self._factories[key] = factory
            return factory

        return deco

    def create(self, name: str, *args: Any, **kw: Any) -> Any:
        key = name.lower()
        if key not in self._factories:
            raise KeyError(f"no {self.kind} named {name!r}; have "
                           f"{sorted(self._factories)}")
        return self._factories[key](*args, **kw)

    def get(self, name: str) -> Optional[Callable[..., Any]]:
        return self._factories.get(name.lower())

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._factories

    def __iter__(self) -> Iterator[Tuple[str, Callable[..., Any]]]:
        return iter(self._factories.items())

    def names(self):
        return sorted(self._factories)


#: datasets, by path extension ("tumrgbd", "kitti", "euroc", ...)
DATASETS = Registry("dataset")
#: robust multi-view estimators
ESTIMATORS = Registry("estimator")
#: nonlinear optimizers
OPTIMIZERS = Registry("optimizer")
#: SLAM systems
SLAMS = Registry("slam")
#: command-line apps
APPS = Registry("app")


def open_dataset(path: str, *args: Any, **kw: Any) -> Any:
    """The dataset registered under ``path``'s extension, opened on
    ``path`` (``/data/kitti/00.kitti`` -> the ``"kitti"`` player)."""
    import gslam_tpu_torch.datasets  # noqa: F401  (fills DATASETS)

    ext = path.rsplit(".", 1)[-1].lower() if "." in path else path.lower()
    ds = DATASETS.create(ext)
    ds.open(path, *args, **kw)
    return ds
