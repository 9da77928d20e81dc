"""Param DSL: typed parameters with defaults + domain validation.

The PyTorch port's own copy of ``mmlspark_tpu/core/params.py`` (that module
is JAX-free, but the port imports nothing of the JAX package). Re-design of
the reference's ``MMLParams`` / ``Wrappable`` contract
system (reference: src/core/contracts/src/main/scala/Params.scala:22-145).
The reference builds typed param factories (BooleanParam/IntParam/...) with
defaults and validation domains on top of Spark ML's Params, and uses that
single source of truth to drive codegen of Python/R bindings and docs.

Here the framework is Python-first, so the DSL *is* the user API: params are
class-level descriptors collected by a metaclass, which also auto-generates
``setFoo``/``getFoo`` accessors (the role played by the reference's codegen,
src/codegen/src/main/scala/PySparkWrapper.scala:33-160).
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Callable, Iterable, Optional

_NO_DEFAULT = object()


class ParamValidationError(ValueError):
    pass


class Param:
    """A declared parameter: name, doc, optional default, optional domain.

    ``jsonable=False`` marks a *complex* param (reference: ComplexParam,
    src/core/serialize/src/main/scala/ComplexParam.scala:10) whose value is not
    JSON-serializable (models, functions, arrays); the serializer stores these
    out-of-band (see mmlspark_tpu_torch.core.serialize).
    """

    __slots__ = ("name", "doc", "default", "validator", "ptype", "jsonable", "owner")

    def __init__(self, doc: str = "", default: Any = _NO_DEFAULT,
                 validator: Optional[Callable[[Any], bool]] = None,
                 ptype: Optional[type] = None, jsonable: bool = True):
        self.name: str = ""  # filled by __set_name__
        self.doc = doc
        self.default = default
        self.validator = validator
        self.ptype = ptype
        self.jsonable = jsonable
        self.owner: Optional[type] = None

    def __set_name__(self, owner, name):
        self.name = name
        self.owner = owner

    @property
    def has_default(self) -> bool:
        return self.default is not _NO_DEFAULT

    def validate(self, value: Any) -> Any:
        if self.ptype is not None and value is not None:
            if self.ptype in (int, float) and isinstance(value, bool):
                raise ParamValidationError(
                    f"Param {self.name}: expected {self.ptype.__name__}, got bool")
            if self.ptype is float and isinstance(value, int):
                value = float(value)
            elif not isinstance(value, self.ptype):
                raise ParamValidationError(
                    f"Param {self.name}: expected {self.ptype.__name__}, "
                    f"got {type(value).__name__} ({value!r})")
        if self.validator is not None and value is not None:
            if not self.validator(value):
                raise ParamValidationError(
                    f"Param {self.name}: value {value!r} outside allowed domain")
        return value

    # descriptor protocol: stage.foo reads the current/default value
    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.getOrDefault(self.name)

    def __set__(self, obj, value):
        obj.set(**{self.name: value})

    def __repr__(self):
        return f"Param({self.name!r}, default={self.default!r})"


# ---- typed factories (reference Params.scala:22-108) -----------------------

def BooleanParam(doc="", default=_NO_DEFAULT):
    return Param(doc, default, ptype=bool)


def IntParam(doc="", default=_NO_DEFAULT, min=None, max=None):
    v = _range_validator(min, max)
    return Param(doc, default, validator=v, ptype=int)


def FloatParam(doc="", default=_NO_DEFAULT, min=None, max=None):
    v = _range_validator(min, max)
    return Param(doc, default, validator=v, ptype=float)


def StringParam(doc="", default=_NO_DEFAULT, choices: Optional[Iterable[str]] = None):
    v = None
    if choices is not None:
        allowed = frozenset(choices)
        v = lambda x: x in allowed
    return Param(doc, default, validator=v, ptype=str)


def ListParam(doc="", default=_NO_DEFAULT):
    return Param(doc, default, ptype=(list, tuple))


def DictParam(doc="", default=_NO_DEFAULT):
    return Param(doc, default, ptype=dict)


def ComplexParam(doc="", default=_NO_DEFAULT):
    """Non-JSON param (model/function/array/stage); serialized out-of-band."""
    return Param(doc, default, jsonable=False)


def _range_validator(lo, hi):
    if lo is None and hi is None:
        return None

    def check(x):
        if lo is not None and x < lo:
            return False
        if hi is not None and x > hi:
            return False
        return True
    return check


# ---- metaclass + base ------------------------------------------------------

def _make_setter(pname):
    def setter(self, value):
        self.set(**{pname: value})
        return self
    setter.__name__ = "set" + pname[0].upper() + pname[1:]
    return setter


def _make_getter(pname):
    def getter(self):
        return self.getOrDefault(pname)
    getter.__name__ = "get" + pname[0].upper() + pname[1:]
    return getter


class ParamsMeta(type):
    """Collects Param descriptors across the MRO; generates set/get accessors."""

    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        declared: dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Param):
                    declared[k] = v
        cls._params = declared
        for pname in declared:
            cap = pname[0].upper() + pname[1:]
            if "set" + cap not in ns and not hasattr(cls, "set" + cap):
                setattr(cls, "set" + cap, _make_setter(pname))
            if "get" + cap not in ns and not hasattr(cls, "get" + cap):
                setattr(cls, "get" + cap, _make_getter(pname))
        return cls


class Params(metaclass=ParamsMeta):
    """Base for anything with declared params (stages, models)."""

    def __init__(self, **kwargs):
        self._paramMap: dict[str, Any] = {}
        if kwargs:
            self.set(**kwargs)

    # -- core accessors --
    @classmethod
    def params(cls) -> dict[str, Param]:
        return dict(cls._params)

    def hasParam(self, name: str) -> bool:
        return name in self._params

    def isSet(self, name: str) -> bool:
        return name in self._paramMap

    def isDefined(self, name: str) -> bool:
        return name in self._paramMap or self._params[name].has_default

    def getOrDefault(self, name: str):
        if name in self._paramMap:
            return self._paramMap[name]
        p = self._params[name]
        if p.has_default:
            return p.default
        raise KeyError(f"Param {name!r} is not set and has no default "
                       f"(on {type(self).__name__})")

    def get(self, name: str, default=None):
        try:
            return self.getOrDefault(name)
        except KeyError:
            return default

    def set(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            if k not in self._params:
                raise KeyError(f"{type(self).__name__} has no param {k!r}; "
                               f"available: {sorted(self._params)}")
            self._paramMap[k] = self._params[k].validate(v)
        return self

    def clear(self, name: str) -> "Params":
        self._paramMap.pop(name, None)
        return self

    def explainParams(self) -> str:
        lines = []
        for name, p in sorted(self._params.items()):
            cur = self._paramMap.get(name, p.default if p.has_default else "(undefined)")
            lines.append(f"{name}: {p.doc} (current: {cur!r})")
        return "\n".join(lines)

    def copy(self, extra: Optional[dict] = None) -> "Params":
        new = _copy.copy(self)
        new._paramMap = dict(self._paramMap)
        if extra:
            new.set(**extra)
        return new

    # -- serialization of the *simple* portion of the param map --
    def _jsonParams(self) -> dict:
        return {k: v for k, v in self._paramMap.items()
                if self._params[k].jsonable}

    def _complexParams(self) -> dict:
        return {k: v for k, v in self._paramMap.items()
                if not self._params[k].jsonable}


# ---- shared column mixins (reference Params.scala:112-145) -----------------

class HasInputCol(Params):
    inputCol = StringParam("The name of the input column", default="input")


class HasOutputCol(Params):
    outputCol = StringParam("The name of the output column", default="output")


class HasInputCols(Params):
    inputCols = ListParam("The names of the input columns", default=())


class HasLabelCol(Params):
    labelCol = StringParam("The name of the label column", default="label")


class HasFeaturesCol(Params):
    featuresCol = StringParam("The name of the features column", default="features")
