"""BRECQ calibration: quantizers, AdaRound, LSQ, the Fisher stream, the
unit loop and the block-reconstruction engine (the port of the JAX
package's ``repro.core``)."""
from .adaround import BetaSchedule  # noqa: F401
from .journal import (CalibJournal, CalibJournalError,  # noqa: F401
                      CalibrationInterrupted)
from .quantizer import QConfig, QState, init_qstate, quantize_dequant  # noqa: F401
from .reconstruction import (PTQResult, ReconConfig, Walker, quantize,  # noqa: F401
                             rtn_on_scales)
