"""Triton assembly to instruction words, the input of the program digest.

The opcodes are the upstream ISA's (triton-isa/src/instruction.rs,
`Instruction::opcode`): protocol constants wired into the processor
table's instruction bits. An instruction with an argument is two words,
its opcode and the argument (a field element for push and addi, a count
or a stack index, a call's target address); every other is one word.
Labels (`name:`) mark addresses; `//` starts a comment.
"""

from __future__ import annotations

from .bfe import P

# name: (opcode, takes an argument)
OPCODES = {
    "halt": (0, False), "push": (1, True), "skiz": (2, False),
    "pop": (3, True), "split": (4, False), "lt": (6, False),
    "nop": (8, False), "divine": (9, True), "assert": (10, False),
    "write_mem": (11, True), "log_2_floor": (12, False), "and": (14, False),
    "return": (16, False), "pick": (17, True), "hash": (18, False),
    "write_io": (19, True), "div_mod": (20, False), "xor": (22, False),
    "recurse": (24, False), "place": (25, True), "assert_vector": (26, False),
    "pop_count": (28, False), "pow": (30, False),
    "recurse_or_return": (32, False), "dup": (33, True),
    "sponge_absorb": (34, False), "merkle_step": (36, False),
    "sponge_init": (40, False), "swap": (41, True), "add": (42, False),
    "merkle_step_mem": (44, False), "sponge_absorb_mem": (48, False),
    "call": (49, True), "mul": (50, False), "sponge_squeeze": (56, False),
    "read_mem": (57, True), "eq": (58, False), "invert": (64, False),
    "addi": (65, True), "xx_add": (66, False), "x_invert": (72, False),
    "read_io": (73, True), "xx_mul": (74, False), "b_horner_step": (80, False),
    "xb_mul": (82, False), "x_horner_step": (88, False),
}


def assemble(text: str) -> list[int]:
    """The program's instruction words; a call's label is resolved to the
    address it marks."""
    tokens = []
    for line in text.splitlines():
        tokens += line.split("//")[0].split()
    labels, address, i = {}, 0, 0
    while i < len(tokens):
        tok = tokens[i]
        if tok.endswith(":"):
            if tok[:-1] in labels:
                raise ValueError(f"label {tok[:-1]!r} defined twice")
            labels[tok[:-1]] = address
            i += 1
            continue
        if tok not in OPCODES:
            raise ValueError(f"unknown instruction {tok!r}")
        arg = OPCODES[tok][1]
        address += 1 + arg
        i += 1 + arg
    words, i = [], 0
    while i < len(tokens):
        tok = tokens[i]
        i += 1
        if tok.endswith(":"):
            continue
        opcode, arg = OPCODES[tok]
        words.append(opcode)
        if arg:
            word = tokens[i]
            i += 1
            words.append(labels[word] if tok == "call" else int(word, 0) % P)
    return words
