"""Generic class-registry factories.

Counterpart of ``mxnet_tpu/registry.py`` (reference registry.py):
``get_register_func`` / ``get_alias_func`` / ``get_create_func`` with the
same creation grammar: for a factory nicknamed ``thing``, create() accepts
an instance, a name, a ``{"thing": "gadget", ...}`` dict, or either JSON
spelling (``'["gadget", {...}]'`` / ``'{"thing": ...}'``). The tables are
one small ``_Registry`` record per base class.
"""
from __future__ import annotations

import json
import logging

from .base import MXNetError

__all__ = ["get_register_func", "get_alias_func", "get_create_func"]


class _Registry:
    """name -> class table for one base class."""

    def __init__(self, base_class, nickname):
        self.base = base_class
        self.nickname = nickname
        self.table = {}

    def add(self, klass, name=None):
        if not issubclass(klass, self.base):
            raise AssertionError("Can only register subclass of %s"
                                 % self.base.__name__)
        key = (klass.__name__ if name is None else name).lower()
        if key in self.table:
            logging.warning("Registering %s %s overrides the existing %s",
                            self.nickname, key, self.table[key].__name__)
        self.table[key] = klass
        return klass

    def lookup(self, key):
        try:
            return self.table[key]
        except KeyError:
            raise MXNetError(
                "%s is not registered; register with %s.register first"
                % (key, self.nickname))


_BY_BASE = {}


def _registry_for(base_class, nickname):
    if base_class not in _BY_BASE:
        _BY_BASE[base_class] = _Registry(base_class, nickname)
    return _BY_BASE[base_class]


def get_register_func(base_class, nickname):
    """Decorator/function registering subclasses of ``base_class``."""
    reg = _registry_for(base_class, nickname)

    def register(klass, name=None):
        return reg.add(klass, name)

    register.__doc__ = ("Register %s to the %s factory"
                        % (nickname, base_class.__name__))
    return register


def get_alias_func(base_class, nickname):
    """``@alias("a", "b")`` decorator registering extra names."""
    reg = _registry_for(base_class, nickname)

    def alias(*names):
        def wrap(klass):
            for name in names:
                reg.add(klass, name)
            return klass
        return wrap

    return alias


def get_create_func(base_class, nickname):
    """Factory accepting an instance / name / config dict / JSON string."""
    reg = _registry_for(base_class, nickname)

    def create(*args, **kwargs):
        spec = args[0] if args else kwargs.pop(nickname)
        rest = args[1:] if args else ()

        if isinstance(spec, base_class):
            if rest or kwargs:
                raise MXNetError(
                    "%s is already an instance; additional arguments are "
                    "invalid" % nickname)
            return spec

        if isinstance(spec, dict):
            if rest or kwargs:
                raise MXNetError("a dict config carries all arguments; "
                                 "extra args/kwargs are invalid")
            return create(**spec)

        if not isinstance(spec, str):
            raise MXNetError("%s must be a string, dict, or %s instance"
                             % (nickname, base_class.__name__))

        head = spec[:1]
        if head in "[{":
            if rest or kwargs:
                raise MXNetError("JSON config takes no extra arguments")
            decoded = json.loads(spec)
            if head == "[":
                inner_name, inner_kwargs = decoded
                return create(inner_name, **inner_kwargs)
            return create(**decoded)

        return reg.lookup(spec.lower())(*rest, **kwargs)

    create.__doc__ = ("Create a %s instance from a name, config dict, or "
                      "JSON string" % nickname)
    return create
