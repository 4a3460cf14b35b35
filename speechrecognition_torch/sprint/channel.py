"""Sprint Core observability tier: channels, components, application
harness (rwth-asr-0.5/src/Core/Channel.hh:106-220, Component.hh,
Application.hh:65-90, XmlStream.hh).

Every Component owns named output channels resolved through the wildcard
configuration (``<selection>.<name>.channel = target[, target...]``);
targets are shared sinks (stdout, stderr, nil, or files) managed by a
ChannelManager, and XML channels emit well-formed fragments inside a
``<sprint>`` document with the reference's escaping rules.  Components
log through ``log()/warning()/error()/criticalError()``, which wrap the
message in the reference's XML message elements with component-path
attribution (Core/Application's default channel wiring: log→stdout,
warning/error→stderr).

The Application harness reproduces Core::Application::run: parse
``--config=FILE`` plus ``--KEY=VALUE`` command-line overrides into the
wildcard SprintConfig, construct the root component, run ``main``, and
report collected error counts / wall time through the channel system —
the framework's CLIs (tools/sprint_tools.py) are thin wrappers that
gain structured XML logging by running inside it.

Port: a copy of speechrecognition_tpu/sprint/channel.py (host code).
"""

from __future__ import annotations

import io
import sys
import time
import xml.sax.saxutils as sax
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO

from .config import SprintConfig


class _Target:
    """One output sink, shared by all channels directed at it
    (Core::Channel::Target)."""

    def __init__(self, name: str, stream: TextIO, xml_document: bool,
                 owns: bool):
        self.name = name
        self.stream = stream
        self.xml_document = xml_document
        self.owns = owns
        self.header_written = False

    def write(self, text: str) -> None:
        if self.xml_document and not self.header_written:
            self.stream.write('<?xml version="1.0" encoding="UTF-8"?>\n'
                              "<sprint>\n")
            self.header_written = True
        self.stream.write(text)
        self.stream.flush()

    def close(self) -> None:
        if self.xml_document and self.header_written:
            self.stream.write("</sprint>\n")
        if self.owns:
            self.stream.close()


class ChannelManager:
    """Creates/reuses targets by name (Core::Channel::Manager)."""

    def __init__(self, config: Optional[SprintConfig] = None,
                 xml_files: bool = True):
        self.config = config or SprintConfig()
        self.xml_files = xml_files
        self._targets: Dict[str, _Target] = {
            "stdout": _Target("stdout", sys.stdout, False, False),
            "stderr": _Target("stderr", sys.stderr, False, False),
            "nil": _Target("nil", io.StringIO(), False, False),
        }

    def target(self, name: str) -> _Target:
        if name not in self._targets:
            self._targets[name] = _Target(
                name, open(name, "w"), self.xml_files, True)
        return self._targets[name]

    def channel(self, component_path: str, name: str,
                default: str = "nil") -> "Channel":
        """Resolve `<component-path>.<name>.channel` through the wildcard
        config; a comma-separated value fans out to several targets."""
        key = f"{component_path}.{name}.channel"
        spec = self.config.get(key)
        if spec is None:
            spec = self.config.get(f"{component_path}.{name}") or default
        targets = [self.target(t.strip())
                   for t in spec.split(",") if t.strip()] if spec else []
        open_ = any(t.name != "nil" for t in targets)
        return Channel(name, targets, open_)

    def close(self) -> None:
        for t in self._targets.values():
            if t.owns:
                t.close()


@dataclass
class Channel:
    name: str
    targets: List[_Target]
    open: bool = True

    def is_open(self) -> bool:
        return self.open and bool(self.targets)

    def write(self, text: str) -> None:
        for t in self.targets:
            if t.name != "nil":
                t.write(text)


class XmlWriter:
    """Structured XML emission onto a Channel (Core::XmlWriter /
    XmlOpen/XmlFull/XmlEmpty composition operators)."""

    def __init__(self, channel: Channel, indent: int = 2):
        self.channel = channel
        self.indent = indent
        self._stack: List[str] = []

    def _pad(self) -> str:
        return " " * (self.indent * len(self._stack))

    @staticmethod
    def _attrs(attrs: Dict[str, object]) -> str:
        return "".join(f' {k}={sax.quoteattr(str(v))}'
                       for k, v in attrs.items())

    def open(self, tag: str, **attrs) -> "XmlWriter":
        self.channel.write(f"{self._pad()}<{tag}{self._attrs(attrs)}>\n")
        self._stack.append(tag)
        return self

    def close(self, tag: Optional[str] = None) -> "XmlWriter":
        top = self._stack.pop()
        if tag is not None and tag != top:
            raise ValueError(f"closing <{tag}> but <{top}> is open")
        self.channel.write(f"{self._pad()}</{top}>\n")
        return self

    def full(self, tag: str, text, **attrs) -> "XmlWriter":
        self.channel.write(
            f"{self._pad()}<{tag}{self._attrs(attrs)}>"
            f"{sax.escape(str(text))}</{tag}>\n")
        return self

    def empty(self, tag: str, **attrs) -> "XmlWriter":
        self.channel.write(f"{self._pad()}<{tag}{self._attrs(attrs)}/>\n")
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        while self._stack:
            self.close()
        return False


class Component:
    """Configurable named object with message channels
    (Core/Component.hh: log/warning/error through the channel system,
    `select()` for child configuration scopes)."""

    def __init__(self, manager: ChannelManager, path: str):
        self.manager = manager
        self.path = path
        self.n_errors = 0
        self.n_warnings = 0
        self._log = manager.channel(path, "log", default="stdout")
        self._warn = manager.channel(path, "warning", default="stderr")
        self._err = manager.channel(path, "error", default="stderr")

    @property
    def name(self) -> str:
        return self.path.rsplit(".", 1)[-1]

    def select(self, sub: str) -> "Component":
        return Component(self.manager, f"{self.path}.{sub}")

    def channel(self, name: str, default: str = "nil") -> Channel:
        return self.manager.channel(self.path, name, default)

    def xml_channel(self, name: str, default: str = "nil") -> XmlWriter:
        return XmlWriter(self.channel(name, default))

    def _message(self, channel: Channel, kind: str, text: str) -> None:
        if channel.is_open():
            channel.write(
                f'<{kind} component={sax.quoteattr(self.path)}>'
                f'{sax.escape(text)}</{kind}>\n')

    def log(self, text: str) -> None:
        self._message(self._log, "log", text)

    def warning(self, text: str) -> None:
        self.n_warnings += 1
        self._message(self._warn, "warning", text)

    def error(self, text: str) -> None:
        self.n_errors += 1
        self._message(self._err, "error", text)

    def critical_error(self, text: str) -> None:
        self.error(text)
        raise RuntimeError(f"{self.path}: {text}")


class Application(Component):
    """Core::Application::run: --config / --KEY=VALUE parsing, root
    component, timing + error summary."""

    def __init__(self, title: str, argv: Optional[List[str]] = None,
                 config: Optional[SprintConfig] = None):
        argv = list(argv or [])
        cfg = config or SprintConfig()
        self.args: List[str] = []
        for a in argv:
            if a.startswith("--config="):
                cfg._read_into(a.split("=", 1)[1], 0)
            elif a.startswith("--") and "=" in a:
                key, val = a[2:].split("=", 1)
                cfg._add(key, val)
            else:
                self.args.append(a)
        super().__init__(ChannelManager(cfg), title)
        self.config = cfg
        self.title = title

    def run(self, main) -> int:
        """Execute `main(self)`; report status like Application::run."""
        t0 = time.perf_counter()
        status = 0
        try:
            status = int(main(self) or 0)
        except RuntimeError as e:   # critical_error
            self._message(self._err, "critical-error", str(e))
            status = 1
        elapsed = time.perf_counter() - t0
        system = self.channel("system-info", default="nil")
        if system.is_open():
            XmlWriter(system).full("elapsed-time", f"{elapsed:.3f}",
                                   unit="s")
        if self.n_errors:
            self._message(self._err, "summary",
                          f"{self.n_errors} errors, "
                          f"{self.n_warnings} warnings")
            status = status or 1
        self.manager.close()
        return status
