from .fastx import (  # noqa: F401
    read_fastx,
    write_fasta,
    reverse_complement,
    detect_filetype,
    FastxRecord,
)
from .seed import set_seed  # noqa: F401
from .timing import Timer, span  # noqa: F401
