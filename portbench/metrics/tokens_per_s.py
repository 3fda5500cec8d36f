"""Real prompt tokens plus generated tokens of the LM requests completed
in the window, over the window's seconds."""


def read(run):
    done = [r for r in run.requests if r.ok and r.done <= run.window_s]
    return sum(r.prompt_len + r.new_tokens for r in done) / run.window_s


