"""Ms per traced step that the card sat idle while the host was inside the
program's ``me.optimizer`` span: the traced window's device idle gaps
intersected with that span's host intervals."""

from benchmark import spans


def read(run):
    return spans.starved_ms(run, "me.optimizer")
