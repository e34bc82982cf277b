"""LayerHelper: shared plumbing for layers.* functions.

Counterpart of ``paddle_tpu/layer_helper.py`` (python/paddle/fluid/
layer_helper.py:49 append_op, :288 create_parameter parity). Parameter and
temporary names are minted exactly as the reference mints them, so a
program built by either package names its parameters alike.
"""

from paddle_tpu_torch import framework, initializer, unique_name
from paddle_tpu_torch.core.types import is_float_dtype
from paddle_tpu_torch.param_attr import ParamAttr


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or framework.default_main_program()

    @property
    def startup_program(self):
        return (self.kwargs.get("startup_program")
                or framework.default_startup_program())

    @property
    def block(self):
        return self.main_program.current_block()

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        attr = self.kwargs.get("bias_attr")
        if attr is False:
            return None
        return ParamAttr._to_attr(attr)

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(self.name + ".tmp"),
            dtype=dtype,
            shape=None,
            stop_gradient=stop_gradient,
        )

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        attr = attr if isinstance(attr, ParamAttr) else ParamAttr._to_attr(attr)
        if attr is None or attr.trainable is None:
            attr = ParamAttr()
        name = attr.name or unique_name.generate("%s.w" % self.name)
        if default_initializer is None:
            if is_bias:
                default_initializer = initializer.ConstantInitializer(0.0)
            elif is_float_dtype(dtype):
                default_initializer = initializer.XavierInitializer()
            else:
                default_initializer = initializer.ConstantInitializer(0.0)
        init = attr.initializer or default_initializer

        param = self.block.create_parameter(
            name=name, shape=shape, dtype=dtype, **{
                "trainable": attr.trainable,
                "optimize_attr": {"learning_rate": attr.learning_rate},
                "regularizer": attr.regularizer,
                "gradient_clip_attr": attr.gradient_clip,
                "do_model_average": attr.do_model_average,
            })
        # Mirror the parameter into the startup program + its init op.
        startup_block = self.startup_program.global_block()
        if not startup_block.has_var(name):
            sp = startup_block.create_parameter(
                name=name, shape=shape, dtype=dtype, trainable=attr.trainable)
            init(sp, startup_block)
        return param

    def create_variable(self, *args, **kwargs):
        return self.block.create_var(*args, **kwargs)

    def create_global_variable(self, shape, dtype, persistable=True,
                               name=None, initializer=None,
                               stop_gradient=True):
        """A variable in the main program's global block, its initializer
        op (when given) in the startup program's (layer_helper.py:92)."""
        gb = self.main_program.global_block()
        var = gb.create_var(
            name=name or unique_name.generate(self.name + ".global"),
            shape=shape, dtype=dtype, persistable=persistable,
            stop_gradient=stop_gradient)
        if initializer is not None:
            self.set_variable_initializer(var, initializer)
        return var

    def set_variable_initializer(self, var, initializer):
        """Mirror ``var`` into the startup program with its initializer
        op, once (layer_helper.py:111)."""
        startup_block = self.startup_program.global_block()
        if not startup_block.has_var(var.name):
            sv = startup_block.create_var(
                name=var.name, shape=var.shape, dtype=var.dtype,
                persistable=True)
            initializer(sv, startup_block)
        return var

    def append_op(self, **kwargs):
        return self.block.append_op(
            type=kwargs["type"],
            inputs=_norm_io(kwargs.get("inputs")),
            outputs=_norm_io(kwargs.get("outputs")),
            attrs=kwargs.get("attrs"),
        )

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = input_var.shape[dim_start:dim_end or len(input_var.shape)]
        bias_attr = self.bias_attr
        if bias_attr is None:
            return input_var
        b = self.create_parameter(
            attr=bias_attr,
            shape=[int(d) for d in size] if len(size) > 1 else [int(size[0])],
            dtype=input_var.dtype,
            is_bias=True,
        )
        tmp = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(
            type=act_type,
            inputs={"X": [input_var]},
            outputs={"Out": [tmp]},
            attrs=act,
        )
        return tmp


def _norm_io(d):
    if not d:
        return {}
    out = {}
    for k, v in d.items():
        if not isinstance(v, (list, tuple)):
            v = [v]
        out[k] = [x.name if hasattr(x, "name") else x for x in v]
    return out
