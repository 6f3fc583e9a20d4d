"""Warm-spare rejoin time, in ms: the port's ``fault.recover_instance``
span, from its start to the completion on the card of the instance's
rebuild (a fresh KV pool around the shared weights), mean over the rejoins
from the window's open until the service stopped. The failure events'
``mttr`` reads the rejoin's schedule instead."""
from servebench import program


def compute(record):
    return program.mean_ms(
        program.spans(record, "fault.recover_instance", until_stop=True))
