"""ParamAttr: per-parameter config bundle (python/paddle/fluid/param_attr.py
parity; a copy of ``paddle_tpu/param_attr.py``)."""

from paddle_tpu_torch import initializer as init_mod


class ParamAttr(object):
    def __init__(
        self,
        name=None,
        initializer=None,
        learning_rate=1.0,
        regularizer=None,
        trainable=True,
        gradient_clip=None,
        do_model_average=False,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, init_mod.Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else ParamAttr(trainable=False)
        raise TypeError("cannot convert %r to ParamAttr" % (arg,))


class WeightNormParamAttr(ParamAttr):
    """A parameter attribute carrying the weight-norm ``dim``
    (param_attr.py WeightNormParamAttr parity)."""

    def __init__(self, dim=None, **kwargs):
        super(WeightNormParamAttr, self).__init__(**kwargs)
        self.dim = dim
