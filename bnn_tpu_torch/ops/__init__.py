from .ste import (SURROGATES, resolve_surrogate, sign, sign_pm1_ste, sign_ste,
                  stochastic_sign_ste, surrogate_sign)
from .registry import register, registered_names, resolve
from .binarizers import (
    AdvancedInputBinarizer,
    BasicInputBinarizer,
    BasicScaleBinarizer,
    BinarizerBase,
    RandomStream,
    Identity,
    StochasticInputBinarizer,
    XNORScaleBinarizer,
    XNORWeightBinarizer,
)

__all__ = [
    "sign",
    "sign_ste",
    "sign_pm1_ste",
    "stochastic_sign_ste",
    "surrogate_sign",
    "resolve_surrogate",
    "SURROGATES",
    "register",
    "resolve",
    "registered_names",
    "BinarizerBase",
    "RandomStream",
    "Identity",
    "BasicInputBinarizer",
    "StochasticInputBinarizer",
    "AdvancedInputBinarizer",
    "XNORWeightBinarizer",
    "BasicScaleBinarizer",
    "XNORScaleBinarizer",
]
