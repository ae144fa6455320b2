"""Svar-style dynamic configuration.

Counterpart of ``gslam_tpu/app/config.py``, the same behaviour in the
port's own copy (pure Python).  The reference's ``Svar``
(``GSLAM/core/Svar.h``) is a JSON-like dynamic value with command-line
parsing (``parseMain``, ``arg<T>(name, def, help)``), config files,
hierarchical dotted keys ("Dataset.Skip") and a thread-safe global
``svar``.  This keeps the *ergonomics* -- ``svar.arg("Dataset.Skip", 0,
"frames to skip")``, ``-dotted.key value`` CLI overrides, JSON config
files -- on a plain nested-dict store.  The class/FFI/plugin half of
Svar maps to :mod:`gslam_tpu_torch.app.registry`.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _coerce(text: str, like: Any) -> Any:
    """Parse `text` to the type of `like` (None -> best-effort literal)."""
    if isinstance(like, bool):
        return text.lower() in ("1", "true", "yes", "on")
    if isinstance(like, int):
        return int(text)
    if isinstance(like, float):
        return float(text)
    if isinstance(like, (list, tuple)):
        # VecParament analog (reference GSLAM/core/VecParament.h):
        # whitespace- or comma-separated vector of the element type.
        elem = like[0] if len(like) else 0.0
        parts = [p for p in text.replace(",", " ").split() if p]
        return type(like)(_coerce(p, elem) for p in parts)
    if isinstance(like, str) or like is None:
        for parse in (int, float):
            try:
                return parse(text)
            except ValueError:
                pass
        if text.lower() in ("true", "false"):
            return text.lower() == "true"
        return text
    return text


class Svar:
    """Nested-dict dynamic config with dotted-key access.

    >>> s = Svar()
    >>> s.parse_main(["-Dataset.Skip", "5", "-play", "true", "pos0"])
    ['pos0']
    >>> s.arg("Dataset.Skip", 0, "frames to skip")
    5
    """

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self._lock = threading.RLock()
        self._data: Dict[str, Any] = dict(data or {})
        self._help: Dict[str, str] = {}

    # -- dotted-key store ---------------------------------------------------
    # A key may be BOTH a scalar and a subtree ("-slam keyframe" plus
    # "-slam.max_kps 128"), like the reference's flat 2.x Svar.  The
    # scalar lives in the subtree dict under the "" slot.
    def _walk(self, key: str, create: bool) -> Tuple[Dict[str, Any], str]:
        parts = key.split(".")
        node = self._data
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                if not create:
                    raise KeyError(key)
                nxt = {} if nxt is None else {"": nxt}
                node[p] = nxt
            node = nxt
        return node, parts[-1]

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            node, leaf = self._walk(key, create=True)
            cur = node.get(leaf)
            if isinstance(cur, dict) and not isinstance(value, dict):
                cur[""] = value  # keep existing dotted children
            else:
                node[leaf] = value

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            try:
                node, leaf = self._walk(key, create=False)
            except KeyError:
                return default
            val = node.get(leaf, default)
            if isinstance(val, dict) and "" in val:
                return val[""]
            return val

    def subtree(self, key: str) -> Dict[str, Any]:
        """Children of a dotted key as a flat dict (scalar slot ""
        excluded): ``-slam keyframe -slam.max_kps 128`` ->
        ``subtree("slam") == {"max_kps": 128}``."""
        with self._lock:
            try:
                node, leaf = self._walk(key, create=False)
            except KeyError:
                return {}
            val = node.get(leaf)
            if not isinstance(val, dict):
                return {}
            return {k: (v[""] if isinstance(v, dict) and "" in v else v)
                    for k, v in val.items() if k != ""}

    def __contains__(self, key: str) -> bool:
        sentinel = object()
        return self.get(key, sentinel) is not sentinel

    def __getitem__(self, key: str) -> Any:
        val = self.get(key, KeyError)
        if val is KeyError:
            raise KeyError(key)
        return val

    def __setitem__(self, key: str, value: Any) -> None:
        self.set(key, value)

    def arg(self, key: str, default: Any, help: str = "") -> Any:
        """Declare+read a parameter (reference ``svar.arg<T>(name,def,help)``).

        If the key was set (CLI/config), coerce the stored value to the type
        of `default`; otherwise store and return the default.
        """
        with self._lock:
            self._help[key] = help
            val = self.get(key, None)
            if val is None:
                self.set(key, default)
                return default
            if isinstance(val, str) and not isinstance(default, str):
                val = _coerce(val, default)
                self.set(key, val)
            return val

    # -- parsing ------------------------------------------------------------
    def parse_main(self, argv: Sequence[str]) -> List[str]:
        """Parse ``-key value`` / ``-flag`` args; returns positional args.

        Mirrors the reference's ``svar.parseMain``: ``-conf file.json``
        loads a config file (lowest precedence), explicit flags win.
        """
        positional: List[str] = []
        file_data: Dict[str, Any] = {}
        i = 0
        argv = list(argv)

        def is_flag(tok: str) -> bool:
            return (tok.startswith("-") and len(tok) > 1
                    and not tok[1].isdigit() and tok[1] != ".")

        while i < len(argv):
            tok = argv[i]
            if is_flag(tok):
                key = tok.lstrip("-")
                if i + 1 < len(argv) and not is_flag(argv[i + 1]):
                    val: Any = _coerce(argv[i + 1], None)
                    i += 2
                else:
                    val = True  # bare flag
                    i += 1
                if key == "conf":
                    with open(val) as f:
                        file_data.update(json.load(f))
                else:
                    self.set(key, val)
            else:
                positional.append(tok)
                i += 1
        # config file fills only keys not set explicitly
        def fill(prefix: str, node: Dict[str, Any]) -> None:
            for k, v in node.items():
                key = f"{prefix}.{k}" if prefix else k
                if isinstance(v, dict):
                    fill(key, v)
                elif key not in self:
                    self.set(key, v)

        fill("", file_data)
        return positional

    def load_json(self, path: str) -> None:
        with open(path) as f:
            data = json.load(f)
        with self._lock:
            self._data.update(data)

    def dump_json(self) -> str:
        with self._lock:
            return json.dumps(self._data, indent=2, default=str)

    def help_table(self) -> str:
        with self._lock:
            rows = [f"  -{k:<30s} (= {self.get(k)!r})  {h}"
                    for k, h in sorted(self._help.items())]
        return "\n".join(rows)


#: process-global config, like the reference's global ``svar``.
svar = Svar()


def parse_args(argv: Sequence[str], into: Optional[Svar] = None) -> List[str]:
    return (into or svar).parse_main(argv)
