"""Hierarchical Scope: name -> runtime value symbol table.

Counterpart of ``paddle_tpu/core/scope.py`` (``scope.h:41`` parity). A
value is a ``torch.Tensor`` on the Place's device (numpy arrays put there
by callers move to the device on first use, see ``Executor``).
"""


class ScopeVariable(object):
    __slots__ = ("name", "value")

    def __init__(self, name):
        self.name = name
        self.value = None

    def set(self, value):
        self.value = value


class Scope(object):
    def __init__(self, parent=None):
        self._vars = {}
        self._parent = parent

    def var(self, name):
        """Find-or-create in this scope (Scope::Var)."""
        v = self._vars.get(name)
        if v is None:
            v = ScopeVariable(name)
            self._vars[name] = v
        return v

    def find_var(self, name):
        """Search this scope then ancestors (Scope::FindVar)."""
        scope = self
        while scope is not None:
            v = scope._vars.get(name)
            if v is not None:
                return v
            scope = scope._parent
        return None

    def new_scope(self):
        """A child scope: lookups fall through to this one."""
        return Scope(parent=self)

    def local_var_names(self):
        return list(self._vars)

    def set_value(self, name, value):
        self.var(name).set(value)

    def get_value(self, name):
        v = self.find_var(name)
        return None if v is None else v.value
