import tasmania_jax.framework.stencil_definitions  # noqa: F401  (register generic stencils)
from tasmania_jax.framework.composite import DiagnosticComponentComposite
from tasmania_jax.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_jax.framework.core_components import (
    DiagnosticComponent,
    ImplicitTendencyComponent,
    Stepper,
    TendencyComponent,
)
from tasmania_jax.framework.dict_operator import DictOperator
from tasmania_jax.framework.field import FieldArray
from tasmania_jax.framework.options import (
    BackendOptions,
    StorageOptions,
    TimeIntegrationOptions,
)
from tasmania_jax.framework.promoter import (
    FromDiagnosticToTendency,
    FromTendencyToDiagnostic,
)
from tasmania_jax.framework.registry import Registry, factor_register, factorize
from tasmania_jax.framework.splitting import (
    ParallelSplitting,
    SequentialTendencySplitting,
    SequentialUpdateSplitting,
)
from tasmania_jax.framework.stencil import (
    StencilFactory,
    compile_stencil,
    compile_subroutine,
    stencil_definition,
    subroutine_definition,
)
from tasmania_jax.framework.steppers import SequentialTendencyStepper, TendencyStepper

__all__ = [
    "DiagnosticComponentComposite",
    "ConcurrentCoupling",
    "DiagnosticComponent",
    "ImplicitTendencyComponent",
    "Stepper",
    "TendencyComponent",
    "DictOperator",
    "FieldArray",
    "BackendOptions",
    "StorageOptions",
    "TimeIntegrationOptions",
    "FromDiagnosticToTendency",
    "FromTendencyToDiagnostic",
    "Registry",
    "factor_register",
    "factorize",
    "ParallelSplitting",
    "SequentialTendencySplitting",
    "SequentialUpdateSplitting",
    "StencilFactory",
    "compile_stencil",
    "compile_subroutine",
    "stencil_definition",
    "subroutine_definition",
    "SequentialTendencyStepper",
    "TendencyStepper",
]
