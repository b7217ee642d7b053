from .greedy import decode_greedy, DecodeResult  # noqa: F401
from .assembly import (  # noqa: F401
    walks_to_contigs,
    save_assembly,
    calculate_n50,
    calculate_ng50,
    quick_evaluation,
    CHM13_CHR_LENS,
)
