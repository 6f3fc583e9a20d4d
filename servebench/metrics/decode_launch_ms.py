"""Mean host time of the port's ``decode.launch`` span in the window, in
ms: one instance's decode step from the call of its eager decode program to
the return of the launch of its last kernel (the program's dispatch). The
step's uploads, each of which waits for the work queued on the card before
it, fall in ``decode.prepare`` instead; a launch still waits where the
card's queue of pending launches is full, as when the card runs behind."""
from servebench import program


def compute(record):
    return program.mean_ms(program.spans(record, "decode.launch"))
