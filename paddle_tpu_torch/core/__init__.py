from . import unique_name
from .executor import Executor, Scope, global_scope, reset_global_scope
from .program import (
    Block,
    Op,
    OpContext,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    program_guard,
    reset_default_programs,
)
from .types import CPUPlace, Place, convert_dtype

__all__ = [
    "unique_name",
    "Executor",
    "Scope",
    "global_scope",
    "reset_global_scope",
    "Block",
    "Op",
    "OpContext",
    "Program",
    "Variable",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "reset_default_programs",
    "CPUPlace",
    "Place",
    "convert_dtype",
]
