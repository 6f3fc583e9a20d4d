"""Failover time, in ms: the port's ``fault.instance`` span, from the kill's
start to the completion on the card of the work it launched (the replication
flush, replica promotion, the victims' adoption), mean over the kills from
the window's open until the service stopped."""
from servebench import program


def compute(record):
    return program.mean_ms(
        program.spans(record, "fault.instance", until_stop=True))
