"""Seconds of set-up the program itself times in its runtime's statistics:
the scene's load and compile (`loading`), the table builds (`build_*`),
the tables' move to the device (`upload`), and the first step where the
cell warms up through `Runtime.step` (`first step`).  None where the
program times no `upload` section.  `setup_s` less this is set-up the
program does not see: imports, the interpreter, the cell's builder."""

SECTIONS = ("loading", "upload", "first step")


def read(run):
    rt = getattr(run.entry, "rt", None)
    st = rt.stats if rt is not None else getattr(run.entry, "stats", None)
    if st is None or "upload" not in st.sections:
        return None
    return sum(s.total for k, s in st.sections.items()
               if k in SECTIONS or k.startswith("build_"))
