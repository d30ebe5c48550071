from .paper_kernels import CASES, get_case  # noqa: F401
